// One pyramid level of the sparse patch correlation through the bf16 product
// surface, for Hopper (sm_90a): CORR_KERNEL="g8c", both of the TPU's stages
// in one launch. Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_g8c`
// (devo_tpu/ops/corr_pallas.py:614, reached through corr_level_banded :738
// with ablate="g8c", pallas_call at :886) together with its XLA glue: lookup_g
// (:968), the index preamble (:784-810) and its stage 2, extract_blend_g8
// (:688). What that kernel is: groups of eight edges share one product,
// eight windows side by side against the block diagonal of their patch
// features, and it writes the raw product surface, bf16, lane 16*j + p =
// edge j of the group, pixel p; extraction, the int8 scale, the blend and the
// mask run afterwards over all edges at once as XLA ops. The surface existed
// because the extraction had to leave the kernel (its docstring records that
// design as a negative result on v5e). Here it stays in shared memory.
//
// What it computes, per edge e, with coords already at this level's
// resolution: the function of ops/corr.corr_level_group, corr_level with
// every integer tap rounded once to bf16 (round to nearest even) before the
// ring slot's scale and the blend -- the rounding of the TPU's bf16 surface:
//   tap[p][di][dj] = bf16(<gmap[kk[e]][p], fmap[jj[e], y0[p] + di - 3,
//                    x0[p] + dj - 3]>) * dq[jj[e]] (int8 rings; 1 else),
//                    0 off the image
//   out            the 7x7 bilinear blend, (E, 49*P*P) f32 in [dx, dy, pixel]
//                  order.
// The surface instance (devo_corr_group_surface) writes the TPU kernel's own
// output instead, (ceil(E / 8), rows, 128) bf16 in its layout: row r * ww + c
// of edge j of a group holds bf16(<gmap[kk][p], fmap[jj, wy0 + r, wx0 + c]>)
// over the edge's covering window at lane 16 j + p, an int8 ring as its
// integer values; an edge whose window exceeds `cap` holds its 64 taps
// (row di * 8 + dj) instead; lanes past P*P are zero, rows past the window
// unwritten (ops/corr.group_surface is its plain version). Nothing on the
// engine's paths launches it: it keeps the TPU kernel's output checkable.
//
// What bounds it on an H100: bytes, the covering windows (about 10x10
// feature vectors an edge at level 1). The design is the edge pipeline of
// corr_pipe.cuh with one level and one edge a step: two pipelines of 256
// threads a block behind a ring of staged windows, the products on the
// tensor cores for bf16 patch features (corr_mma.cuh) and on the CUDA cores
// for f32 ones, each sum rounded to bf16 as it leaves the accumulator, the
// f32 surface in shared memory, extraction and blend from it. A level's
// window is about half of K1's two, so two blocks share an SM (512 threads
// each, at most 64 registers a thread): four pipelines an SM, whose waits
// overlap one another's work (ops/corr_cuda.group_plan).

#include "corr_pipe.cuh"

namespace {

using namespace devo;

// one level, one edge a step, two pipelines, at most four stages, bf16 taps
using Fused = PipeShape<1, 1, 2, 4, true, false, false>;
using Surface = PipeShape<1, 1, 2, 4, true, true, false>;

template <typename G, typename F>
__global__ void __launch_bounds__(kPipeBlock, 2)
corr_group_kernel(const PipeArgs<G, F> args) {
  edge_pipeline<G, F, Fused>(args);
}

template <typename G, typename F>
__global__ void __launch_bounds__(kPipeBlock, 2)
corr_group_surface_kernel(const PipeArgs<G, F> args) {
  edge_pipeline<G, F, Surface>(args);
}

template <typename G, typename F>
size_t smem_bytes(int PP, int C, int cap, int depth) {
  return PipeLayout<G, F, Fused>(PP, C, cap).bytes(depth);
}

bool bad_plan(int PP, int cap, int depth, int run, int g_bf16) {
  return PP > kMaxPP || depth < Fused::kPipes || depth > Fused::kMaxDepth ||
         depth % Fused::kPipes != 0 || run < 1 || (g_bf16 && cap % 16 != 0);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C), bf16 if g_bf16 else f32;
// fmap (mem, H, W, C) of gmap's type, or int8 if ring_i8, and then dq (mem,)
// f32 holds the slots' scales (null otherwise); coords (E, P, P, 2) f32 at
// this level's resolution; kk / jj (E,) int32; out (E, 49*P*P) f32. C is a
// multiple of 4, P*P at most 16. `cap`: feature vectors of a staged window (a
// multiple of 16 for bf16 patch features; 0 = every tap reads the ring),
// `depth`: stages (2 or 4, half of them each pipeline's), `run`: consecutive
// edges a block walks. The dynamic shared memory taken is
// devo_corr_group_smem's, that of ops/corr_cuda.group_smem_bytes.
extern "C" int devo_corr_group(const void* gmap, const void* fmap,
                               const void* dq, const void* coords,
                               const void* kk, const void* jj, void* out,
                               int E, int PP, int C, int H, int W, int cap,
                               int g_bf16, int ring_i8, int depth, int run,
                               void* stream) {
  if (E == 0) return 0;
  if (bad_plan(PP, cap, depth, run, g_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (E + run - 1) / run;
#define DEVO_LAUNCH(G, F)                                                   \
  launch_pipe<Fused>(corr_group_kernel<G, F>,                               \
              PipeArgs<G, F>{level_args<G, F>(gmap, fmap, dq, coords, kk,   \
                                              jj, out, E, PP, C, H, W, cap), \
                             depth, run, nullptr, 0},                       \
              grid, smem_bytes<G, F>(PP, C, cap, depth), st)
  return DEVO_PIPE_TYPES(DEVO_LAUNCH);
#undef DEVO_LAUNCH
}

// The surface instance: the arguments of devo_corr_group without dq and out,
// and surface (ceil(E / 8), rows, 128) bf16, rows at least the larger of cap
// and 64. Writes the rows and lanes described above and nothing else.
extern "C" int devo_corr_group_surface(const void* gmap, const void* fmap,
                                       const void* coords, const void* kk,
                                       const void* jj, void* surface, int E,
                                       int PP, int C, int H, int W, int cap,
                                       int rows, int g_bf16, int ring_i8,
                                       int depth, int run, void* stream) {
  if (E == 0) return 0;
  if (bad_plan(PP, cap, depth, run, g_bf16) || rows < cap ||
      rows < kTaps * kTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (E + run - 1) / run;
#define DEVO_LAUNCH(G, F)                                                   \
  launch_pipe<Surface>(corr_group_surface_kernel<G, F>,                     \
              PipeArgs<G, F>{level_args<G, F>(gmap, fmap, nullptr, coords,  \
                                              kk, jj, nullptr, E, PP, C, H, \
                                              W, cap),                      \
                             depth, run,                                    \
                             static_cast<__nv_bfloat16*>(surface), rows},   \
              grid, smem_bytes<G, F>(PP, C, cap, depth), st)
  return DEVO_PIPE_TYPES(DEVO_LAUNCH);
#undef DEVO_LAUNCH
}

// The dynamic shared memory devo_corr_group (and its surface instance) takes.
extern "C" long long devo_corr_group_smem(int PP, int C, int cap, int depth,
                                          int g_bf16, int ring_i8) {
#define DEVO_SMEM(G, F) static_cast<long long>(smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_SMEM);
#undef DEVO_SMEM
}

// Blocks of devo_corr_group's kernel that one SM of the current device holds
// at these sizes, or minus the cudaError_t of the query.
extern "C" int devo_corr_group_blocks_per_sm(int PP, int C, int cap, int depth,
                                             int g_bf16, int ring_i8) {
#define DEVO_OCC(G, F)                                                   \
  pipe_blocks_per_sm<Fused>(corr_group_kernel<G, F>,                     \
                     smem_bytes<G, F>(PP, C, cap, depth))
  return DEVO_PIPE_TYPES(DEVO_OCC);
#undef DEVO_OCC
}
