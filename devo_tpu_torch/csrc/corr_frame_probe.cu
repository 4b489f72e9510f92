// The one-frame window product, for Hopper (sm_90a): per edge a 16 x 24
// window of one resident bf16 frame at a given origin, its product with the
// edge's 16 patch rows, and either the pixels' tap strips or the product's
// first rows. Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/probe_cuda.py; the plain version is
// ops/probe.frame_windows.
//
// Replaces the TPU kernel `kern` of `mk_kernel(extract, nsc)`
// (scripts/bench_gather.py:75, pallas_call at :104): the frame resident in
// VMEM, the window fmap[y0:y0+16, 8 x08 : 8 x08 + 24] an edge, one (384, C) x
// (C, 16) product, and with `extract` the strips out[r, 16p + c] =
// S[ry + r, 8 rx8 + c, p] (E, 8, 144), else out[y, j] = S[y, j // 16, j % 16]
// (E, 16, 144). Every read is inside the window (ry < 9, rx8 < 2). `nsc` only
// rotated the TPU's result scratches and is gone.
//
// What bounds it on an H100: the frame (6.8 MB) stays in the 50 MB L2; from
// device memory come the patch rows (63 MB at E = 15360), the indices and the
// output (71 MB, or 142 MB without extraction), about 0.04 or 0.06 ms at 3.35
// TB/s, against 24 GFLOP of products (0.024 ms at the bf16 tensor-core
// rate). But an edge that stages its own 96 KB window moves 1.51 GB a
// launch from L2 to the SMs, which L2's bandwidth, not device memory,
// bounds. The design is csrc/window_probe.cuh's, shared with
// corr_band_ablate.cu: persistent blocks over all E edges, windows staged
// by cp.async in chunks of 32 channels, the products on the tensor cores;
// the edges come sorted by window origin (about 2560 origins for the
// driver's 15360 edges), and each staged chunk serves a group of up to
// kGroup edges of one window: at the driver's draw about 6100 windows are
// staged (0.6 GB from L2; the kernel's own count, `staged` below). Groups
// of three keep two blocks an SM (128 registers a thread); each edge still
// takes its 384 mma.sync, surface and strips. Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py): about
// 0.26 ms alone, 0.34-0.35 ms through the wrapper, whose sort of the edges
// (ten launches) takes 0.09-0.11 ms alone.

#include "window_probe.cuh"

namespace {

using namespace devo;

constexpr int kGroup = 3;      // edges of one window a group

struct FrameFront {
  const __nv_bfloat16* fmap;   // (Hp, Wp, C)
  const int* y0;               // (E, 1)
  const int* x08;              // (E, 1)
  const int* order;            // (E,), edges of one window adjacent
  size_t row_stride;           // Wp * C

  __device__ int edges(int E) const { return E; }
  __device__ size_t edge(int j) const { return __ldg(order + j); }
  __device__ const __nv_bfloat16* origin(size_t e) const {
    return fmap + __ldg(y0 + e) * row_stride +
           8 * __ldg(x08 + e) * window_probe::kC;
  }
};

template <int kMode>
int occupancy(int depth) {
  return window_probe::blocks_per_sm<FrameFront, kMode, kGroup>(depth);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. fmap (hp, wp, 128) bf16, 16-byte aligned; gm
// (E, 16, 128) bf16; y0, x08 (E, 1) int32; ry, rx8 (E, 16) int32; order (E,)
// int32, a permutation of the edges in which those of one window are
// adjacent (ops/probe_cuda.frame_order; any permutation gives the same
// bits, adjacency only saves copies); out
// (E, 8, 144) f32 with `extract`, else (E, 16, 144) f32. `grid` is the
// number of persistent blocks (at most one an edge is launched), `depth`
// (2 .. 4) the stages of the window ring. The dynamic shared memory taken is
// that of ops/probe_cuda.window_smem_bytes (devo_corr_frame_probe_smem).
// `staged`: null, or an unsigned long long on the device to which the kernel
// adds one for each window it stages (a window serves a group of edges).
extern "C" int devo_corr_frame_probe(const void* fmap, const void* gm,
                                     const void* y0, const void* x08,
                                     const void* ry, const void* rx8,
                                     const void* order, void* out, int E,
                                     int wp, int grid, int depth, int extract,
                                     void* staged, void* stream) {
  const FrameFront f{static_cast<const __nv_bfloat16*>(fmap),
                     static_cast<const int*>(y0), static_cast<const int*>(x08),
                     static_cast<const int*>(order),
                     static_cast<size_t>(wp) * window_probe::kC};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return extract
             ? window_probe::launch<FrameFront, window_probe::kFull, kGroup>(
                   f, gm, ry, rx8, out, E, grid, depth, st, staged)
             : window_probe::launch<FrameFront, window_probe::kSurfaceRows, kGroup>(
                   f, gm, ry, rx8, out, E, grid, depth, st, staged);
}

// The dynamic shared memory devo_corr_frame_probe takes at `depth` stages.
extern "C" long long devo_corr_frame_probe_smem(int depth) {
  return static_cast<long long>(window_probe::smem_bytes(depth, kGroup));
}

// Blocks of devo_corr_frame_probe's kernel (with or without `extract`) that
// one SM of the current device holds at `depth` stages, or minus the
// cudaError_t of the query.
extern "C" int devo_corr_frame_probe_blocks_per_sm(int extract, int depth) {
  return extract ? occupancy<window_probe::kFull>(depth)
                 : occupancy<window_probe::kSurfaceRows>(depth);
}
