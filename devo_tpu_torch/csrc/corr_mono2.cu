// Both pyramid levels of the sparse patch correlation in one launch, two
// edges a block, for Hopper (sm_90a). Plain C interface, loaded with ctypes
// by devo_tpu_torch/ops/corr_cuda.py.
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
// rings, no bands, stagger, 24-wide windows or bf16 strip output;
// out-of-image taps are zero by a bounds check, and the blended (E, 882) f32
// feature is written here.
//
// What it computes: the function of csrc/corr.cu, csrc/corr_pair.cu and
// csrc/corr_pair2.cu (ops/corr.corr_pyramid is the plain version), coords /
// lvl divided here so that all floor the same values.
//
// What bounds it on an H100: bytes, and below the byte bound the latency of
// the window reads and the shared-memory traffic of the dots. What the
// design does:
//   - block b takes edges 2b and 2b+1 (the last block of an odd E takes one);
//     warps 0 and 1 work out one edge's floors, fractions and covering
//     windows each (EdgePrep);
//   - the four windows (two edges x two levels, each the union of the nine
//     pixels' 8x8 tap grids, at most `cap` vectors) are copied into adjacent
//     stages of shared memory with cp.async, level 1 of both edges as one
//     commit group and level 4 of both as the next, while both patch
//     features are converted to f32;
//   - per level one pass of tap dots over the pair: 2 x 576 taps over 384
//     threads, one thread a tap taking the whole dot over C (dot_rotated);
//     level 1's pass starts after wait_group 1, while level 4's copies fly;
//   - the flag `concat` (CORR_KERNEL="mono2"): before a level's pass the two
//     edges' windows are gathered from their stages into one contiguous
//     buffer by a copy through the registers, and the dots read that buffer;
//     without it ("mono4") the dots address the windows where the copies
//     landed. The copy costs shared memory (two more windows) and a barrier;
//   - a level whose window exceeds `cap`, or a ring whose feature vector is
//     no multiple of 16 bytes (cap = 0), reads its taps from the ring.
// The two edges of a pair often share the patch or the frame in the engine's
// (kk, jj)-sorted table; nothing here assumes it.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 384;

template <typename G, typename F, bool kConcat>
__global__ void __launch_bounds__(kThreads)
corr_mono2_kernel(const PairArgs<G, F> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePrep prep[2];
  const int PP = a.PP, C = a.C;
  const int per_level = PP * kTaps * kTaps;
  float* g = reinterpret_cast<float*>(smem_raw);      // (2, PP, C) f32
  float* taps = g + 2 * PP * C;                       // (2 edges, 2, PP, 8, 8)
  F* stage = reinterpret_cast<F*>(taps + 4 * per_level);  // (2 edges, 2, cap, C)
  const size_t win_elems = static_cast<size_t>(a.cap) * C;
  F* cat = stage + 4 * win_elems;                     // (2 * cap, C) if kConcat

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int e0 = 2 * blockIdx.x;
  const int n_e = min(2, a.E - e0);

  if (tid < 32 * n_e) {
    const size_t e = e0 + tid / 32;
    prep_edge(prep[tid / 32], a, a.coords + e * PP * 2, a.kk[e], a.jj[e], lane);
  }
  __syncthreads();

  auto ring_slot = [&](int k, int lvl) {
    return a.fmap[lvl] +
           static_cast<size_t>(prep[k].frame) * a.H[lvl] * a.W[lvl] * C;
  };
  auto staged = [&](int k, int lvl) { return stage + (2 * k + lvl) * win_elems; };
  for (int lvl = 0; lvl < 2; ++lvl) {
    for (int k = 0; k < n_e; ++k)
      stage_window(staged(k, lvl), ring_slot(k, lvl), prep[k], lvl, a.H[lvl],
                   a.W[lvl], C, tid, kThreads);
    cp_async_commit();
  }

  // both patch features while the windows fly
  for (int k = 0; k < n_e; ++k) {
    const G* gsrc = a.gmap + static_cast<size_t>(prep[k].kk) * PP * C;
    for (int i = tid; i < PP * C; i += kThreads)
      g[k * PP * C + i] = to_float(gsrc[i]);
  }

  const int start = (kVec * lane) % C;
  for (int lvl = 0; lvl < 2; ++lvl) {
    if (lvl == 0) cp_async_wait<1>(); else cp_async_wait<0>();
    // everyone's copies of this level landed, g is written, and the last
    // level's dots are done with `cat`
    __syncthreads();
    const F* win[2] = {staged(0, lvl), staged(1, lvl)};
    if (kConcat) {
      // the two windows side by side: edge 0's vectors, then edge 1's
      const int n0 = prep[0].ww[lvl] * prep[0].wh[lvl];
      const int n1 = n_e > 1 ? prep[1].ww[lvl] * prep[1].wh[lvl] : 0;
      constexpr int kChunk = 16 / sizeof(F);
      const int chunks = C / kChunk;
      for (int i = tid; i < (n0 + n1) * chunks; i += kThreads) {
        const int v = i / chunks;
        const int ch = (i - v * chunks) * kChunk;
        const F* src = v < n0 ? win[0] + static_cast<size_t>(v) * C
                              : win[1] + static_cast<size_t>(v - n0) * C;
        *reinterpret_cast<uint4*>(cat + static_cast<size_t>(v) * C + ch) =
            *reinterpret_cast<const uint4*>(src + ch);
      }
      win[0] = cat;
      win[1] = cat + static_cast<size_t>(n0) * C;
      __syncthreads();
    }
    for (int it = tid; it < n_e * per_level; it += kThreads) {
      const int k = it >= per_level;
      const int rem = it - k * per_level;
      taps[(2 * k + lvl) * per_level + rem] =
          pair_tap(g + k * PP * C, win[k], ring_slot(k, lvl), prep[k], lvl,
                   rem / (kTaps * kTaps), rem % (kTaps * kTaps), a.H[lvl],
                   a.W[lvl], C, start);
    }
  }
  __syncthreads();

  const int n_out = 2 * kOut * kOut * PP;
  for (int k = 0; k < n_e; ++k)
    blend_pair_row(a.out + static_cast<size_t>(e0 + k) * n_out,
                   taps + 2 * k * per_level, prep[k], PP, tid, kThreads);
}

template <typename G, typename F, bool kConcat>
int launch(const PairArgs<G, F>& a, cudaStream_t st) {
  const size_t smem =
      2 * (static_cast<size_t>(a.PP) * a.C + 2 * a.PP * kTaps * kTaps) *
          sizeof(float) +
      (kConcat ? 6 : 4) * static_cast<size_t>(a.cap) * a.C * sizeof(F);
  const cudaError_t err =
      allow_shared_memory(corr_mono2_kernel<G, F, kConcat>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_mono2_kernel<G, F, kConcat>
      <<<(a.E + 1) / 2, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. The arguments are those of devo_corr_pair
// (csrc/corr_pair.cu), and `concat`: 1 = gather each pair of windows into one
// buffer before its dots ("mono2"), 0 = read them in place ("mono4"). The
// dynamic shared memory taken is that of ops/corr_cuda.mono2_smem_bytes.
extern "C" int devo_corr_mono2(const void* gmap, const void* fmap1,
                               const void* fmap2, const void* dq1,
                               const void* dq2, const void* coords,
                               const void* kk, const void* jj, void* out, int E,
                               int PP, int C, int h1, int w1, int h2, int w2,
                               int cap, float lvl1, float lvl2, int g_bf16,
                               int ring_i8, int concat, void* stream) {
  if (E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_ARGS(G, F)                                                       \
  pair_args<G, F>(gmap, fmap1, fmap2, dq1, dq2, coords, kk, jj, out, E, PP,   \
                  C, h1, w1, h2, w2, cap, lvl1, lvl2)
#define DEVO_LAUNCH(G, F)                                                     \
  (concat ? launch<G, F, true>(DEVO_ARGS(G, F), st)                           \
          : launch<G, F, false>(DEVO_ARGS(G, F), st))
  if (g_bf16)
    return ring_i8 ? DEVO_LAUNCH(__nv_bfloat16, int8_t)
                   : DEVO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  return ring_i8 ? DEVO_LAUNCH(float, int8_t) : DEVO_LAUNCH(float, float);
#undef DEVO_LAUNCH
#undef DEVO_ARGS
}
