// One pyramid level of the sparse patch correlation with the product surface
// kept in the block and every tap exact, for Hopper (sm_90a):
// CORR_KERNEL="g8". Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_g8` (devo_tpu/ops/corr_pallas.py:549,
// reached through corr_level_banded :738 with ablate="g8", pallas_call at
// :928) together with its XLA glue: lookup_g (:968), the index preamble
// (:784-810) and ops/corr.blend_strips. What that kernel is: groups of eight
// edges share one product, eight windows side by side against the block
// diagonal of their patch features (which fills the MXU's 128 lanes with
// 8 edges x 16 pixels, 7/8 of the product zeros), an f32 surface in VMEM,
// and the extraction of every edge's tap strips in the same block. The
// grouping has no counterpart on mma.sync, where a patch's pixels already
// are the N dimension of each edge's own product: a block diagonal would
// only multiply zeros. This kernel keeps what the TPU kernel keeps out of
// device memory -- the f32 surface, the extraction and blend in the same
// block -- and its exact taps, and none of the TPU's shapes: plain
// (mem, h, w, C) rings, no bands, stagger or 24-wide windows.
//
// What it computes, per edge e, with coords already at this level's
// resolution: ops/corr.corr_level on float rings, unclipped:
//   tap[p][di][dj] = <gmap[kk[e]][p], fmap[jj[e], y0[p] + di - 3,
//                    x0[p] + dj - 3]>, f32 sums of the products, never
//                    rounded; 0 off the image
//   out            the 7x7 bilinear blend, (E, 49*P*P) f32 in [dx, dy, pixel]
//                  order.
// That is what separates it from csrc/corr_group.cu (K8'', "g8c"), which
// rounds each tap to bf16 as the TPU's bf16 surface did.
//
// What bounds it on an H100: bytes, the covering windows (about 10x10
// feature vectors an edge at level 1). The design is the edge pipeline of
// corr_pipe.cuh in K8''s shape, without the rounding: one level, one edge a
// step, two pipelines of 256 threads a block walking a run of consecutive
// edges behind a ring of staged windows (two barriers a step); the products
// on the tensor cores (corr_mma.cuh) for bf16 rings, on the CUDA cores
// (position_products) for f32 rings; the f32 surface in shared memory,
// extraction and blend from it; a window beyond `cap` takes its taps from
// the ring, one dot a tap. The plan is K8''s (ops/corr_cuda.group_plan): at
// C = 128 on bf16 rings two stages of 48,960 bytes and two slots of 5,760,
// 109,440 bytes a block, two blocks an SM (512 threads each, at most 64
// registers a thread): four pipelines an SM, whose waits overlap one
// another's work.
// No atomics, and every sum in a fixed order: two launches give the same
// bits.

#include "corr_pipe.cuh"

namespace {

using namespace devo;

// one level, one edge a step, two pipelines, at most four stages, exact taps
using Group8 = PipeShape<1, 1, 2, 4, false, false, false>;

// F: type of the rings and of the patch features (bf16 or f32)
template <typename F>
__global__ void __launch_bounds__(kPipeBlock, 2)
corr_group8_kernel(const PipeArgs<F, F> args) {
  edge_pipeline<F, F, Group8>(args);
}

template <typename F>
size_t smem_bytes(int PP, int C, int cap, int depth) {
  return PipeLayout<F, F, Group8>(PP, C, cap).bytes(depth);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C) and fmap (mem, H, W, C),
// both bf16 if bf16 else f32; coords (E, P, P, 2) f32 at this level's
// resolution; kk / jj (E,) int32; out (E, 49*P*P) f32. C is a multiple of 4,
// P*P at most 16. `cap`: feature vectors of a staged window (a multiple of
// 16 for bf16; 0 = every tap reads the ring), `depth`: stages (2 or 4, half
// of them each pipeline's), `run`: consecutive edges a block walks. The
// dynamic shared memory taken is devo_corr_group8_smem's, that of
// ops/corr_cuda.group_smem_bytes.
extern "C" int devo_corr_group8(const void* gmap, const void* fmap,
                                const void* coords, const void* kk,
                                const void* jj, void* out, int E, int PP, int C,
                                int H, int W, int cap, int bf16, int depth,
                                int run, void* stream) {
  if (E == 0) return 0;
  if (PP > kMaxPP || depth < Group8::kPipes || depth > Group8::kMaxDepth ||
      depth % Group8::kPipes != 0 || run < 1 || (bf16 && cap % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (E + run - 1) / run;
#define DEVO_LAUNCH(F)                                                      \
  launch_pipe<Group8>(corr_group8_kernel<F>,                                \
              PipeArgs<F, F>{level_args<F, F>(gmap, fmap, nullptr, coords,  \
                                              kk, jj, out, E, PP, C, H, W,  \
                                              cap),                         \
                             depth, run, nullptr, 0},                       \
              grid, smem_bytes<F>(PP, C, cap, depth), st)
  return bf16 ? DEVO_LAUNCH(__nv_bfloat16) : DEVO_LAUNCH(float);
#undef DEVO_LAUNCH
}

// The dynamic shared memory devo_corr_group8 takes at these sizes.
extern "C" long long devo_corr_group8_smem(int PP, int C, int cap, int depth,
                                           int bf16) {
  return static_cast<long long>(bf16 ? smem_bytes<__nv_bfloat16>(PP, C, cap, depth)
                                     : smem_bytes<float>(PP, C, cap, depth));
}

// Blocks of devo_corr_group8's kernel that one SM of the current device holds
// at these sizes, or minus the cudaError_t of the query. The arguments are
// those of devo_corr_group_blocks_per_sm (csrc/corr_group.cu); the rings are
// float (ring_i8 = 0) and of the patch features' type.
extern "C" int devo_corr_group8_blocks_per_sm(int PP, int C, int cap,
                                              int depth, int bf16,
                                              int ring_i8) {
  if (ring_i8) return -static_cast<int>(cudaErrorInvalidValue);
  return bf16 ? pipe_blocks_per_sm<Group8>(
                    corr_group8_kernel<__nv_bfloat16>,
                    smem_bytes<__nv_bfloat16>(PP, C, cap, depth))
              : pipe_blocks_per_sm<Group8>(corr_group8_kernel<float>,
                                           smem_bytes<float>(PP, C, cap, depth));
}
