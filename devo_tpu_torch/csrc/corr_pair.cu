// Both pyramid levels of the sparse patch correlation in one launch, one
// block per edge, each level's window on its own stream of asynchronous
// copies, for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_pair`
// (devo_tpu/ops/corr_pallas.py:1225, reached through corr_pyramid_banded
// :1962 -> corr_pyramid_pair :1311, pallas_call at :1408) together with its
// XLA glue: lookup_g (:968), _pair_level_index (:1195), the one-hot scale
// lookup and ops/corr.blend_strips for both levels. What that kernel is: one
// pass over the edges for both levels, the edge's patch feature brought in
// once and used for both, and one copy pipeline per level so that one
// level's copies hide behind the other level's dots. This kernel keeps
// that and none of the TPU's shapes: plain (mem, h, w, C) rings, no bands,
// stagger, 24-wide windows, R scratch or strip output; out-of-image taps are
// zero by a bounds check, and the blended (E, 882) feature is written here.
//
// What it computes, per edge e (one block each):
//   g     = gmap[kk[e]]                              (P*P pixels x C)
//   level l in {0, 1}: ring fmap_l, coords / lvl_l (divided here, as
//         csrc/corr.cu does, so both floor the same values)
//   taps  t[l][p][di][dj] = <g[p], fmap_l[jj[e], y0+di-3, x0+dj-3]>, the 8x8
//         integer grid around floor(coord of pixel p); with int8 rings the
//         dot is over the integer values, times the slot's scale dq_l[jj[e]]
//   out   the 7x7 bilinear blend, (E, 2*49*P*P) f32 in [dx, dy, pixel, level]
//         order (ops/corr.corr_pyramid, the plain version of this kernel).
// Accumulation is f32.
//
// What bounds it on an H100: bytes (295k FLOP an edge against two windows of
// ~100 feature vectors each), and below the byte bound the latency of the
// window reads. What the design does about it:
//   - warp 0 works out the edge's floors, fractions and the two covering
//     windows once (EdgePrep) instead of every thread for itself;
//   - the level-1 window and the level-4 window (each the union of the nine
//     pixels' 8x8 tap grids, about 10x10 vectors, at most `cap`) are copied
//     into shared memory with cp.async, 16 bytes a copy, each level as its
//     own commit group; the patch feature is read once, converted to f32 in
//     shared memory while the copies fly, and serves both levels;
//   - the level-1 dots start after cp.async.wait_group 1, while the level-4
//     copies may still be in flight; the level-4 dots follow wait_group 0;
//   - one thread per tap takes the whole dot over C from shared memory, the
//     lanes of a warp starting at different channels (dot_rotated): 288
//     threads are two rounds of the 576 taps of a level at P = 3;
//   - a level whose window exceeds `cap` (a strongly distorted patch), or a
//     ring whose feature vector is no multiple of 16 bytes (cap = 0), reads
//     its taps directly from the ring.
// Several blocks share an SM (four at C = 128 on int8 rings, two on bf16
// rings), so one edge's copies also hide behind another edge's dots.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 288;

template <typename G, typename F>
__global__ void __launch_bounds__(kThreads)
corr_pair_kernel(const PairArgs<G, F> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePrep ep;
  const int PP = a.PP, C = a.C;
  const int per_level = PP * kTaps * kTaps;
  float* g = reinterpret_cast<float*>(smem_raw);      // (PP, C) patch feature
  float* taps = g + PP * C;                           // (2, PP, 8, 8) tap dots
  F* win1 = reinterpret_cast<F*>(taps + 2 * per_level);   // (cap, C)
  F* win2 = win1 + static_cast<size_t>(a.cap) * C;        // (cap, C)

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;

  if (tid < 32)
    prep_edge(ep, a, a.coords + static_cast<size_t>(e) * PP * 2, a.kk[e],
              a.jj[e], lane);
  __syncthreads();

  const F* fbase1 = a.fmap[0] + static_cast<size_t>(ep.frame) * a.H[0] * a.W[0] * C;
  const F* fbase2 = a.fmap[1] + static_cast<size_t>(ep.frame) * a.H[1] * a.W[1] * C;
  stage_window(win1, fbase1, ep, 0, a.H[0], a.W[0], C, tid, kThreads);
  cp_async_commit();
  stage_window(win2, fbase2, ep, 1, a.H[1], a.W[1], C, tid, kThreads);
  cp_async_commit();

  // the patch feature, once for both levels, while the windows fly
  const G* gsrc = a.gmap + static_cast<size_t>(ep.kk) * PP * C;
  for (int i = tid; i < PP * C; i += kThreads) g[i] = to_float(gsrc[i]);

  const int start = (kVec * lane) % C;
  cp_async_wait<1>();               // this thread's level-1 copies landed
  __syncthreads();                  // everyone's did, and g is written
  for (int it = tid; it < per_level; it += kThreads)
    taps[it] = pair_tap(g, win1, fbase1, ep, 0, it / (kTaps * kTaps),
                        it % (kTaps * kTaps), a.H[0], a.W[0], C, start);
  cp_async_wait<0>();
  __syncthreads();
  for (int it = tid; it < per_level; it += kThreads)
    taps[per_level + it] =
        pair_tap(g, win2, fbase2, ep, 1, it / (kTaps * kTaps),
                 it % (kTaps * kTaps), a.H[1], a.W[1], C, start);
  __syncthreads();

  blend_pair_row(a.out + static_cast<size_t>(e) * 2 * kOut * kOut * PP, taps,
                 ep, PP, tid, kThreads);
}

template <typename G, typename F>
int launch(const PairArgs<G, F>& a, cudaStream_t st) {
  const size_t smem =
      (static_cast<size_t>(a.PP) * a.C + 2 * a.PP * kTaps * kTaps) * sizeof(float) +
      2 * static_cast<size_t>(a.cap) * a.C * sizeof(F);
  const cudaError_t err = allow_shared_memory(corr_pair_kernel<G, F>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_pair_kernel<G, F><<<a.E, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C), bf16 if g_bf16 else f32;
// fmap1 (mem, h1, w1, C) and fmap2 (mem, h2, w2, C) of gmap's type, or int8
// if ring_i8, and then dq1, dq2 (mem,) f32 hold the slots' scales (null
// otherwise); coords (E, P, P, 2) f32 at level-1 resolution, divided by lvl1
// and lvl2 in the kernel; kk / jj (E,) int32 ring indices; out
// (E, 2*49*P*P) f32. C is a multiple of 4 and P*P at most 16. `cap` is the
// number of feature vectors of each level's staged window (0 = read every
// tap from the ring); a vector must then be a multiple of 16 bytes. The
// dynamic shared memory taken is that of ops/corr_cuda.pair_smem_bytes.
extern "C" int devo_corr_pair(const void* gmap, const void* fmap1,
                              const void* fmap2, const void* dq1,
                              const void* dq2, const void* coords,
                              const void* kk, const void* jj, void* out, int E,
                              int PP, int C, int h1, int w1, int h2, int w2,
                              int cap, float lvl1, float lvl2, int g_bf16,
                              int ring_i8, void* stream) {
  if (E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(G, F)                                                     \
  launch(pair_args<G, F>(gmap, fmap1, fmap2, dq1, dq2, coords, kk, jj, out,   \
                         E, PP, C, h1, w1, h2, w2, cap, lvl1, lvl2),          \
         st)
  if (g_bf16)
    return ring_i8 ? DEVO_LAUNCH(__nv_bfloat16, int8_t)
                   : DEVO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  return ring_i8 ? DEVO_LAUNCH(float, int8_t) : DEVO_LAUNCH(float, float);
#undef DEVO_LAUNCH
}
