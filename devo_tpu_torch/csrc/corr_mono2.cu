// Both pyramid levels of the sparse patch correlation, two edges a pipeline
// step, for Hopper (sm_90a): CORR_KERNEL="mono2" / "mono4". Plain C
// interface, loaded with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_mono` in its two-edge forms
// (devo_tpu/ops/corr_pallas.py:1553 with step2 / adj2, :1618-1658; reached
// through corr_pyramid_banded :1962 -> corr_pyramid_pair2 :1835, pallas_call
// at :1944, variant="mono2" and variant="mono4") together with its XLA glue:
// lookup_g (:968), _pair_level_index (:1195), the one-hot scale lookup and
// ops/corr.blend_strips for both levels. What those variants are: the mono
// kernel's function with two edges a step, the two edges' stacked windows
// against the pair of patch blocks in one dot. "mono2" first concatenates
// the two windows by a copy; "mono4" reads two adjacent ring slots as one
// slice, in place. The cross products of one edge's window with the other
// edge's patch, which the TPU's one dot computes and throws away, are not
// computed here. None of the TPU's shapes is kept: plain (mem, h, w, C)
// rings, no bands, stagger, 24-wide windows or bf16 strip output.
//
// What it computes: the function of csrc/corr.cu (ops/corr.corr_pyramid is
// the plain version), coords / lvl divided here so that all floor the same
// values, as (E, 2*49*P*P) f32 in [dx, dy, pixel, level] order.
//
// What bounds it on an H100: bytes, as csrc/corr.cu. The design is the edge
// pipeline of corr_pipe.cuh with both levels and a pair of edges a step:
//   - a step stages the pair's patch features and both levels' covering
//     windows of both edges together, the two edges' windows of a level
//     adjacent; one barrier before the pair's products and one after, where
//     K1 has them for each edge;
//   - the m-tiles of both edges and both levels are spread over the
//     pipeline's warps (tensor cores for bf16 patch features, CUDA cores for
//     f32 ones); each m-tile is multiplied by its own edge's patch only;
//   - "mono4" (concat = 0): the m-tiles read each edge's window where its
//     copies landed. "mono2" (concat = 1): after the pair's copies landed,
//     edge 1's rows of each level are copied through the registers to
//     follow edge 0's, behind two barriers of their own, so that the level's
//     two windows form one contiguous run of rows, and edge 1's m-tiles read
//     it there: the TPU's concatenation, and its cost;
//   - shared memory sets the plan (ops/corr_cuda.mono2_plan): a pair's stage
//     is twice K1's, so int8 rings take two pipelines of one stage each
//     (windows of 128 vectors), bf16 rings one pipeline of one stage.
// No atomics, and every sum in a fixed order: two launches give the same
// bits.

#include "corr_pipe.cuh"

namespace {

using namespace devo;

// both levels, a pair of edges a step, `Pipes` pipelines, at most two stages
template <int Pipes, bool Gather>
using Pair = PipeShape<2, 2, Pipes, 2, false, false, Gather>;

template <typename G, typename F, int Pipes, bool Gather>
__global__ void __launch_bounds__(kPipeBlock, 1)
corr_mono2_kernel(const PipeArgs<G, F> args) {
  edge_pipeline<G, F, Pair<Pipes, Gather>>(args);
}

template <typename G, typename F>
size_t smem_bytes(int PP, int C, int cap, int depth, int pipes) {
  return pipes == 2 ? PipeLayout<G, F, Pair<2, false>>(PP, C, cap).bytes(depth)
                    : PipeLayout<G, F, Pair<1, false>>(PP, C, cap).bytes(depth);
}

// Two pipelines only for bf16 patch features on int8 rings, the one pair of
// types whose stages fit them.
template <typename G, typename F>
constexpr bool kTwoPipes = kMma<G> && std::is_same<F, int8_t>::value;

template <typename G, typename F, bool Gather>
int launch(const PipeArgs<G, F>& args, int pipes, cudaStream_t st) {
  const PairArgs<G, F>& a = args.p;
  const int grid = (a.E + args.run - 1) / args.run;
  const size_t smem = smem_bytes<G, F>(a.PP, a.C, a.cap, args.depth, pipes);
  if constexpr (kTwoPipes<G, F>) {
    if (pipes == 2)
      return launch_pipe<Pair<2, Gather>>(corr_mono2_kernel<G, F, 2, Gather>,
                                          args, grid, smem, st);
  }
  return launch_pipe<Pair<1, Gather>>(corr_mono2_kernel<G, F, 1, Gather>, args,
                                      grid, smem, st);
}

template <typename G, typename F>
int blocks_per_sm(int PP, int C, int cap, int depth, int pipes) {
  const size_t smem = smem_bytes<G, F>(PP, C, cap, depth, pipes);
  if constexpr (kTwoPipes<G, F>) {
    if (pipes == 2)
      return pipe_blocks_per_sm<Pair<2, false>>(
          corr_mono2_kernel<G, F, 2, false>, smem);
  }
  return pipe_blocks_per_sm<Pair<1, false>>(corr_mono2_kernel<G, F, 1, false>,
                                            smem);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. The arguments are those of devo_corr_pyramid
// (csrc/corr.cu), and `concat`: 1 = gather each pair's windows of a level
// into one run of rows before its products ("mono2"), 0 = read them where
// the copies landed ("mono4"); `depth`: stages of the block (1 or 2 with
// one pipeline, 2 with two), `pipes`: pipelines a block (2 only for bf16
// patch features on int8 rings), `run`: consecutive edges a block walks. The
// dynamic shared memory taken is devo_corr_mono2_smem's, that of
// ops/corr_cuda.mono2_smem_bytes.
extern "C" int devo_corr_mono2(const void* gmap, const void* fmap1,
                               const void* fmap2, const void* dq1,
                               const void* dq2, const void* coords,
                               const void* kk, const void* jj, void* out, int E,
                               int PP, int C, int h1, int w1, int h2, int w2,
                               int cap, float lvl1, float lvl2, int g_bf16,
                               int ring_i8, int concat, int depth, int pipes,
                               int run, void* stream) {
  if (E == 0) return 0;
  if (PP > kMaxPP || pipes < 1 || pipes > 2 || (pipes == 2 && !(g_bf16 && ring_i8)) ||
      depth < pipes || depth > 2 || depth % pipes != 0 || run < 1 ||
      (g_bf16 && cap % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(G, F)                                                     \
  (concat ? launch<G, F, true>(ARGS(G, F), pipes, st)                         \
          : launch<G, F, false>(ARGS(G, F), pipes, st))
#define ARGS(G, F)                                                            \
  PipeArgs<G, F>{pair_args<G, F>(gmap, fmap1, fmap2, dq1, dq2, coords, kk,    \
                                 jj, out, E, PP, C, h1, w1, h2, w2, cap,      \
                                 lvl1, lvl2),                                 \
                 depth, run, nullptr, 0}
  return DEVO_PIPE_TYPES(DEVO_LAUNCH);
#undef ARGS
#undef DEVO_LAUNCH
}

// The dynamic shared memory devo_corr_mono2 takes at these sizes.
extern "C" long long devo_corr_mono2_smem(int PP, int C, int cap, int depth,
                                          int pipes, int g_bf16, int ring_i8) {
#define DEVO_SMEM(G, F) \
  static_cast<long long>(smem_bytes<G, F>(PP, C, cap, depth, pipes))
  return DEVO_PIPE_TYPES(DEVO_SMEM);
#undef DEVO_SMEM
}

// Blocks of devo_corr_mono2's kernel that one SM of the current device holds
// at these sizes, or minus the cudaError_t of the query.
extern "C" int devo_corr_mono2_blocks_per_sm(int PP, int C, int cap, int depth,
                                             int pipes, int g_bf16,
                                             int ring_i8) {
#define DEVO_OCC(G, F) blocks_per_sm<G, F>(PP, C, cap, depth, pipes)
  return DEVO_PIPE_TYPES(DEVO_OCC);
#undef DEVO_OCC
}
