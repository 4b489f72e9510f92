// One pyramid level of the sparse patch correlation per launch by persistent
// blocks that keep the next edge's window in flight while they compute the
// current one, for Hopper (sm_90a). Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_split2`
// (devo_tpu/ops/corr_pallas.py:441, reached through corr_level_banded :738
// with ablate="split2" -> _split2_call :511, pallas_call at :540) together
// with its XLA glue: lookup_g (:968), the index preamble (:784-810), the
// one-hot scale lookup (:824-826) and ops/corr.blend_strips. What that
// kernel adds to `_kernel_banded_split`: grid step b streams block b's
// windows and products while it extracts block b-1, so the copy engine never
// idles through an extraction; its output block lags one step. On the TPU the
// grid runs in order and carries the copies from one step to the next; here
// blocks run in no order and share nothing, so a loop inside the block takes
// the grid's place, and it is to csrc/corr_level.cu what `_kernel_banded_pair2`
// is to `_kernel_banded_pair`. None of the TPU's shapes is kept: plain
// (mem, h, w, C) rings, no bands, stagger, 24-wide windows, R double buffer
// or strip output; out-of-image taps are zero by a bounds check, and the
// blended (E, 441) f32 feature is written here.
//
// What it computes: the function of csrc/corr_level.cu
// (ops/corr.corr_level is the plain version), with coords already at this
// level's resolution.
//
// What bounds it on an H100: bytes, and below the byte bound the latency of
// the window reads, which corr_level.cu leaves to the scheduler (nine blocks
// of an SM take turns). What this design does instead:
//   - a persistent grid, as many blocks as fit the SMs at once (the launch
//     asks the occupancy calculator), block b taking edges b, b + grid, ...;
//   - two stages of shared memory, each with the raw patch feature and the
//     edge's window (the union of the nine pixels' 8x8 tap grids, at most
//     `cap` vectors): in step n the block first starts the cp.async copies of
//     edge n+1 (patch feature, window, and the coordinates and indices of
//     edge n+3) as one commit group, then waits for edge n's group
//     (wait_group 1), converts its patch feature to f32, takes its 576 tap
//     dots (192 threads: three rounds at P = 3), blends and writes its row,
//     all while edge n+1's copies fly: the output is one step behind the
//     copies;
//   - warp 0 works out edge n+2's floors, fractions and window (EdgePrep)
//     during step n from the coordinates that step n-1's group brought, so no
//     step waits on a load from device memory other than its own group.
// Shared memory at C = 128 and cap 144: 6.9 KB of f32 patch feature and taps
// plus per stage 2.3 KB of raw bf16 feature and a window of 18 KB (int8) or
// 36 KB (bf16): 48 KB a block on int8 rings, 85 KB on bf16 rings.
//
// Hazards, for the reader of the loop: buffers are reused across steps only
// across the barriers S1-S3 of every step. Stage n&1 is read by step n's
// convert and dots (before S3 of step n) and written by the group started at
// the top of step n+1. `g` and `taps` are written after S1 / S2 of a step and
// last read before S3 / S1 of the next. EdgePrep slot n%4 is written in step
// n-2 and last read by step n's blend; its next writer is step n+2, two
// barriers later. The coordinates of edge n+2 lie in slot n%2 of `meta`:
// written by step n-1's group, read by warp 0 between S1 and S2 of step n,
// written again by the group started in step n+1.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 192;
constexpr int kPrepSlots = 4;

// an edge's coordinates and ring indices as they lie in device memory
struct __align__(16) EdgeMeta {
  float ce[2 * kMaxPP];
  int kk, jj;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) / 16 * 16; }

// a stage: the raw patch feature, then the window
template <typename G, typename F>
__host__ __device__ inline size_t stage_bytes(int PP, int C, int cap) {
  return round16(static_cast<size_t>(PP) * C * sizeof(G)) +
         static_cast<size_t>(cap) * C * sizeof(F);
}

template <typename G, typename F>
__global__ void __launch_bounds__(kThreads)
corr_level_pipe_kernel(const PairArgs<G, F> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePrep prep[kPrepSlots];
  __shared__ EdgeMeta meta[2];
  const int PP = a.PP, C = a.C, H = a.H[0], W = a.W[0];
  const int n_taps = PP * kTaps * kTaps;
  float* g = reinterpret_cast<float*>(smem_raw);      // (PP, C) patch feature
  float* taps = g + PP * C;                           // (PP, 8, 8) tap dots
  unsigned char* stages = reinterpret_cast<unsigned char*>(taps + n_taps);
  const size_t graw_bytes = static_cast<size_t>(PP) * C * sizeof(G);
  const size_t per_stage = stage_bytes<G, F>(PP, C, a.cap);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int start = (kVec * lane) % C;
  const int n_out = kOut * kOut * PP;
  // this block's edges: first, first + stride, ...
  const int first = blockIdx.x, stride = gridDim.x;
  const int count = (a.E - first + stride - 1) / stride;

  auto graw = [&](int n) {
    return reinterpret_cast<G*>(stages + (n & 1) * per_stage);
  };
  auto window = [&](int n) {
    return reinterpret_cast<F*>(stages + (n & 1) * per_stage +
                                round16(graw_bytes));
  };
  auto ring_slot = [&](const EdgePrep& ep) {
    return a.fmap[0] + static_cast<size_t>(ep.frame) * H * W * C;
  };
  // the copies of this block's n-th edge into stage n&1, and the coordinates
  // and indices of its (n+2)-th edge into meta[n&1]
  auto start_copies = [&](int n) {
    const EdgePrep& ep = prep[n % kPrepSlots];
    const unsigned char* gsrc = reinterpret_cast<const unsigned char*>(
        a.gmap + static_cast<size_t>(ep.kk) * PP * C);
    unsigned char* gdst = reinterpret_cast<unsigned char*>(graw(n));
    for (int i = tid * 8; i < static_cast<int>(graw_bytes); i += kThreads * 8)
      cp_async8(gdst + i, gsrc + i);
    stage_window(window(n), ring_slot(ep), ep, 0, H, W, C, tid, kThreads);
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
      prep_edge<1>(prep[n], a, a.coords + e * PP * 2, a.kk[e], a.jj[e], lane);
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
      prep_edge<1>(prep[(n + 2) % kPrepSlots], a, m.ce, m.kk, m.jj, lane);
    }
    __syncthreads();                // S2

    const EdgePrep& ep = prep[n % kPrepSlots];
    const F* fbase = ring_slot(ep);
    for (int it = tid; it < n_taps; it += kThreads)
      taps[it] = pair_tap(g, window(n), fbase, ep, 0, it / (kTaps * kTaps),
                          it % (kTaps * kTaps), H, W, C, start);
    __syncthreads();                // S3

    const size_t e = first + static_cast<size_t>(n) * stride;
    blend_level_row(a.out + e * n_out, taps, ep, 0, PP, tid, kThreads);
  }
}

template <typename G, typename F>
size_t smem_bytes(int PP, int C, int cap) {
  return (static_cast<size_t>(PP) * C + PP * kTaps * kTaps) * sizeof(float) +
         2 * stage_bytes<G, F>(PP, C, cap);
}

// blocks of the kernel that one SM holds at a time, or -cudaError_t
template <typename G, typename F>
int blocks_per_sm(int PP, int C, int cap) {
  const size_t smem = smem_bytes<G, F>(PP, C, cap);
  cudaError_t err = allow_shared_memory(corr_level_pipe_kernel<G, F>, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, corr_level_pipe_kernel<G, F>, kThreads, smem);
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
  corr_level_pipe_kernel<G, F>
      <<<grid, kThreads, smem_bytes<G, F>(a.PP, a.C, a.cap), st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. The arguments are those of devo_corr_level
// (csrc/corr_level.cu); gmap and coords are 16-byte aligned, as the copies
// into shared memory need, and P*P is at most 16. The grid is the number of
// blocks the device holds at a time (SMs x blocks per SM), at most E. The
// dynamic shared memory taken is that of ops/corr_cuda.level_pipe_smem_bytes.
extern "C" int devo_corr_level_pipe(const void* gmap, const void* fmap,
                                    const void* dq, const void* coords,
                                    const void* kk, const void* jj, void* out,
                                    int E, int PP, int C, int H, int W, int cap,
                                    int g_bf16, int ring_i8, void* stream) {
  if (E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(G, F)                                                     \
  launch(level_args<G, F>(gmap, fmap, dq, coords, kk, jj, out, E, PP, C, H,   \
                          W, cap),                                            \
         st)
  if (g_bf16)
    return ring_i8 ? DEVO_LAUNCH(__nv_bfloat16, int8_t)
                   : DEVO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  return ring_i8 ? DEVO_LAUNCH(float, int8_t) : DEVO_LAUNCH(float, float);
#undef DEVO_LAUNCH
}

// Blocks of devo_corr_level_pipe's kernel that one SM of the current device
// holds at a time for these sizes and types (the persistent grid is that
// times the number of SMs), or minus the cudaError_t of the query.
extern "C" int devo_corr_level_pipe_blocks_per_sm(int PP, int C, int cap,
                                                  int g_bf16, int ring_i8) {
  if (g_bf16)
    return ring_i8 ? blocks_per_sm<__nv_bfloat16, int8_t>(PP, C, cap)
                   : blocks_per_sm<__nv_bfloat16, __nv_bfloat16>(PP, C, cap);
  return ring_i8 ? blocks_per_sm<float, int8_t>(PP, C, cap)
                 : blocks_per_sm<float, float>(PP, C, cap);
}
