// Both pyramid levels of the sparse patch correlation in one launch by
// persistent blocks: each block walks over many edges and keeps the next
// edge's windows in flight while it computes the current one, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_pair2`
// (devo_tpu/ops/corr_pallas.py:1433, reached through corr_pyramid_banded
// :1962 -> corr_pyramid_pair2 :1835, pallas_call at :1944, variant="pair2")
// together with its XLA glue: lookup_g (:968), _pair_level_index (:1195),
// the one-hot scale lookup and ops/corr.blend_strips for both levels. What
// that kernel adds to `_kernel_banded_pair`: its copy stream never drains at
// a block boundary (a global copy index, the output one block behind). On
// the TPU the grid runs in order and carries the copies from one step to the
// next; here blocks run in no order and nothing carries between them, so a
// loop inside the block takes the grid's place. None of the TPU's shapes is
// kept: plain (mem, h, w, C) rings, no bands, stagger, 24-wide windows, R
// scratch or bf16 strip output; out-of-image taps are zero by a bounds
// check, and the blended (E, 882) f32 feature is written here.
//
// What it computes: the function of csrc/corr_pair.cu and csrc/corr.cu
// (ops/corr.corr_pyramid is the plain version), coords / lvl divided here so
// that all three floor the same values.
//
// What bounds it on an H100: bytes, and below the byte bound the latency of
// the window reads, which a block per edge leaves to the scheduler (other
// blocks of the SM run while one waits). What this design does instead:
//   - a persistent grid, as many blocks as fit the SMs at once (the launch
//     asks the occupancy calculator), block b taking edges b, b + grid, ...;
//   - two stages of shared memory, each with the raw patch feature and one
//     window per level (the union of the nine pixels' 8x8 tap grids, at most
//     `cap` vectors): in step n the block first starts the cp.async copies
//     of edge n+1 (patch feature, both windows, and the coordinates and
//     indices of edge n+3) as one commit group, then waits for edge n's
//     group (wait_group 1), converts its patch feature to f32, takes its
//     2 x 576 tap dots (384 threads: three rounds at P = 3), blends and
//     writes its row, all while edge n+1's copies fly;
//   - warp 0 works out edge n+2's floors, fractions and windows (EdgePrep)
//     during step n from the coordinates that step n-1's group brought, so
//     no step waits on a load from device memory other than its own group.
// Shared memory at C = 128: 9.2 KB of f32 patch feature and taps plus per
// stage 2.3 KB of raw bf16 feature and two windows, 36 KB (int8) or 72 KB
// (bf16) at cap 144: 87 KB a block on int8 rings (two blocks an SM), 163 KB
// on bf16 rings (one).
//
// Hazards, for the reader of the loop: buffers are reused across steps only
// across the barriers S1-S3 of every step. Stage n&1 (windows, raw feature)
// is read by step n's convert and dots (before S3 of step n) and written by
// the group started at the top of step n+1. `g` and `taps` are written after
// S1 / S2 of a step and last read before S3 / S1 of the next. EdgePrep slot
// n%4 is written in step n-2 and last read by step n's blend; its next
// writer is step n+2, two barriers later. The coordinates of edge n+2 lie
// in slot n%2 of `meta`: written by step n-1's group, read by warp 0 between
// S1 and S2 of step n, written again by the group started in step n+1.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 384;
constexpr int kPrepSlots = 4;

// an edge's coordinates and ring indices as they lie in device memory
struct __align__(16) EdgeMeta {
  float ce[2 * kMaxPP];
  int kk, jj;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// dynamic shared memory: g and taps as f32, then two stages of (raw patch
// feature, level-1 window, level-4 window)
template <typename G, typename F>
__host__ __device__ inline size_t stage_bytes(int PP, int C, int cap) {
  return round16(static_cast<size_t>(PP) * C * sizeof(G)) +
         2 * static_cast<size_t>(cap) * C * sizeof(F);
}

template <typename G, typename F>
__global__ void __launch_bounds__(kThreads)
corr_pair2_kernel(const PairArgs<G, F> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePrep prep[kPrepSlots];
  __shared__ EdgeMeta meta[2];
  const int PP = a.PP, C = a.C;
  const int per_level = PP * kTaps * kTaps;
  float* g = reinterpret_cast<float*>(smem_raw);      // (PP, C) patch feature
  float* taps = g + PP * C;                           // (2, PP, 8, 8) tap dots
  unsigned char* stages = reinterpret_cast<unsigned char*>(taps + 2 * per_level);
  const size_t graw_bytes = static_cast<size_t>(PP) * C * sizeof(G);
  const size_t win_bytes = static_cast<size_t>(a.cap) * C * sizeof(F);
  const size_t per_stage = stage_bytes<G, F>(PP, C, a.cap);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int start = (kVec * lane) % C;
  const int n_out = 2 * kOut * kOut * PP;
  // this block's edges: first, first + stride, ...
  const int first = blockIdx.x, stride = gridDim.x;
  const int count = (a.E - first + stride - 1) / stride;

  auto graw = [&](int n) {
    return reinterpret_cast<G*>(stages + (n & 1) * per_stage);
  };
  auto window = [&](int n, int lvl) {
    return reinterpret_cast<F*>(stages + (n & 1) * per_stage +
                                round16(graw_bytes) + lvl * win_bytes);
  };
  auto ring_slot = [&](const EdgePrep& ep, int lvl) {
    return a.fmap[lvl] + static_cast<size_t>(ep.frame) * a.H[lvl] * a.W[lvl] * C;
  };
  // the copies of this block's n-th edge into stage n&1, and the
  // coordinates and indices of its (n+2)-th edge into meta[n&1]
  auto start_copies = [&](int n) {
    const EdgePrep& ep = prep[n % kPrepSlots];
    const unsigned char* gsrc = reinterpret_cast<const unsigned char*>(
        a.gmap + static_cast<size_t>(ep.kk) * PP * C);
    unsigned char* gdst = reinterpret_cast<unsigned char*>(graw(n));
    for (int i = tid * 8; i < static_cast<int>(graw_bytes); i += kThreads * 8)
      cp_async8(gdst + i, gsrc + i);
    stage_window(window(n, 0), ring_slot(ep, 0), ep, 0, a.H[0], a.W[0], C, tid,
                 kThreads);
    stage_window(window(n, 1), ring_slot(ep, 1), ep, 1, a.H[1], a.W[1], C, tid,
                 kThreads);
    if (n + 2 < count) {
      const size_t e = first + static_cast<size_t>(n + 2) * stride;
      EdgeMeta& m = meta[n & 1];
      if (tid < PP)
        cp_async8(m.ce + 2 * tid, a.coords + (e * PP + tid) * 2);
      else if (tid == PP)
        cp_async4(&m.kk, a.kk + e);
      else if (tid == PP + 1)
        cp_async4(&m.jj, a.jj + e);
    }
  };

  // the first two edges' index tables straight from device memory
  if (tid < 32) {
    for (int n = 0; n < 2 && n < count; ++n) {
      const size_t e = first + static_cast<size_t>(n) * stride;
      prep_edge(prep[n], a, a.coords + e * PP * 2, a.kk[e], a.jj[e], lane);
    }
  }
  __syncthreads();
  start_copies(0);
  cp_async_commit();

  for (int n = 0; n < count; ++n) {
    if (n + 1 < count) start_copies(n + 1);
    cp_async_commit();              // a group every step, empty at the end
    cp_async_wait<1>();             // this thread's copies of edge n landed
    __syncthreads();                // S1: everyone's did

    const G* gr = graw(n);
    for (int i = tid; i < PP * C; i += kThreads) g[i] = to_float(gr[i]);
    if (tid < 32 && n + 2 < count) {
      const EdgeMeta& m = meta[n & 1];
      prep_edge(prep[(n + 2) % kPrepSlots], a, m.ce, m.kk, m.jj, lane);
    }
    __syncthreads();                // S2

    const EdgePrep& ep = prep[n % kPrepSlots];
    const F* fbase1 = ring_slot(ep, 0);
    const F* fbase2 = ring_slot(ep, 1);
    for (int it = tid; it < 2 * per_level; it += kThreads) {
      const int lvl = it >= per_level;
      const int rem = it - lvl * per_level;
      taps[it] = pair_tap(g, window(n, lvl), lvl ? fbase2 : fbase1, ep, lvl,
                          rem / (kTaps * kTaps), rem % (kTaps * kTaps),
                          lvl ? a.H[1] : a.H[0], lvl ? a.W[1] : a.W[0], C,
                          start);
    }
    __syncthreads();                // S3

    const size_t e = first + static_cast<size_t>(n) * stride;
    blend_pair_row(a.out + e * n_out, taps, ep, PP, tid, kThreads);
  }
}

template <typename G, typename F>
size_t smem_bytes(int PP, int C, int cap) {
  return (static_cast<size_t>(PP) * C + 2 * PP * kTaps * kTaps) * sizeof(float) +
         2 * stage_bytes<G, F>(PP, C, cap);
}

// blocks of the kernel that one SM holds at a time, or -cudaError_t
template <typename G, typename F>
int blocks_per_sm(int PP, int C, int cap) {
  const size_t smem = smem_bytes<G, F>(PP, C, cap);
  cudaError_t err = allow_shared_memory(corr_pair2_kernel<G, F>, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, corr_pair2_kernel<G, F>, kThreads, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return occ;
}

template <typename G, typename F>
int launch(const PairArgs<G, F>& a, cudaStream_t st) {
  const int occ = blocks_per_sm<G, F>(a.PP, a.C, a.cap);
  if (occ < 0) return -occ;
  if (occ == 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long resident = static_cast<long long>(sms) * occ;
  const int grid = static_cast<int>(a.E < resident ? a.E : resident);
  corr_pair2_kernel<G, F>
      <<<grid, kThreads, smem_bytes<G, F>(a.PP, a.C, a.cap), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. The arguments are those of devo_corr_pair
// (csrc/corr_pair.cu); gmap and coords are 16-byte aligned, as the copies
// into shared memory need. The grid is the number of blocks the device holds
// at a time (SMs x blocks per SM), at most E. The dynamic shared memory taken
// is that of ops/corr_cuda.pair2_smem_bytes.
extern "C" int devo_corr_pair2(const void* gmap, const void* fmap1,
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

// Blocks of devo_corr_pair2's kernel that one SM of the current device holds
// at a time for these sizes and types (the persistent grid is that times the
// number of SMs), or minus the cudaError_t of the query.
extern "C" int devo_corr_pair2_blocks_per_sm(int PP, int C, int cap, int g_bf16,
                                             int ring_i8) {
  if (g_bf16)
    return ring_i8 ? blocks_per_sm<__nv_bfloat16, int8_t>(PP, C, cap)
                   : blocks_per_sm<__nv_bfloat16, __nv_bfloat16>(PP, C, cap);
  return ring_i8 ? blocks_per_sm<float, int8_t>(PP, C, cap)
                 : blocks_per_sm<float, float>(PP, C, cap);
}
