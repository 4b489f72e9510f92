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
// rate). This first version shares csrc/window_probe.cuh with
// corr_band_ablate.cu: the window rows are staged by cp.async two edges ahead
// of the products, which run on the f32 units, one window position a thread;
// the products, not the bytes, take the time.

#include "window_probe.cuh"

namespace {

using namespace devo;

struct FrameFront {
  const __nv_bfloat16* fmap;   // (Hp, Wp, C)
  const int* y0;               // (E, 1)
  const int* x08;              // (E, 1)
  int wp;

  __device__ const __nv_bfloat16* row(int e, int r) const {
    const size_t at = static_cast<size_t>(__ldg(y0 + e) + r) * wp + 8 * __ldg(x08 + e);
    return fmap + at * window_probe::kC;
  }
  __device__ bool live(int) const { return true; }
};

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. fmap (hp, wp, 128) bf16, 16-byte aligned; gm
// (E, 16, 128) bf16; y0, x08 (E, 1) int32; ry, rx8 (E, 16) int32; out
// (E, 8, 144) f32 with `extract`, else (E, 16, 144) f32. `run` is the edges
// a block walks, `depth` (2 .. 4) the stages of the window ring. The dynamic
// shared memory taken is that of ops/probe_cuda.window_smem_bytes.
extern "C" int devo_corr_frame_probe(const void* fmap, const void* gm,
                                     const void* y0, const void* x08,
                                     const void* ry, const void* rx8,
                                     void* out, int E, int wp, int run,
                                     int depth, int extract, void* stream) {
  const FrameFront f{static_cast<const __nv_bfloat16*>(fmap),
                     static_cast<const int*>(y0), static_cast<const int*>(x08),
                     wp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return extract ? window_probe::launch<FrameFront, window_probe::kFull>(
                       f, gm, ry, rx8, out, E, run, depth, st)
                 : window_probe::launch<FrameFront, window_probe::kSurfaceRows>(
                       f, gm, ry, rx8, out, E, run, depth, st);
}
