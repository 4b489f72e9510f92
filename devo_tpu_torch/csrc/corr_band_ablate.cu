// The banded window ablation, for Hopper (sm_90a): per edge a 16 x 24 window
// of a 5-D band ring, its product with the edge's 16 patch rows, and the
// pixels' tap strips read from that product, each stage of the loop removable
// to time the others. Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/probe_cuda.py; the plain version is
// ops/probe.band_ablate.
//
// Replaces the TPU kernel `make_kernel(mode)._kernel`
// (scripts/bench_banded_ablate.py:27, pallas_call at :114): the body of
// devo_tpu's `_kernel_banded` (ops/corr_pallas.py:289) on a (MEM, NBX, Hp,
// 24, C) ring, the window addressed by (slot, band, y0) and the extraction
// offsets (ry, rx) passed in. Its modes: "full" (copy, product, extraction),
// "noext" (no extraction: the first 72 rows of the product), "nomm" (no
// product: window values), "noDMA" (no copy). What the port defines where
// the TPU kernel read unwritten scratch: a strip column at or past 24 reads
// 0, and "noDMA" multiplies a window zeroed once, so its output is 0.
//
// The live gate is the TPU kernel's: a block of BE = 64 edges computes if its
// first edge lies below nlive[0], which the kernel reads on the device (the
// host never does); a block past it writes nothing.
//
// What bounds it on an H100: at the driver's point (6144 live edges) the
// bytes, 98 KB of window, 4 KB of patch rows and 4.6 KB of output an edge,
// about 0.66 GB or 0.2 ms at 3.35 TB/s, against 9.7 GFLOP of products (0.01 ms
// at the bf16 tensor-core rate). This first version multiplies on the f32
// units, one window position a thread (csrc/window_probe.cuh): 786 K
// multiply-adds an edge on 128 lanes an SM, which takes longer than the
// copy. What the design keeps from the TPU kernel is its loop: a ring of
// window stages filled ahead of the products, two at C = 128 (a stage is 96
// KB of the 227 KB a block may have).

#include "window_probe.cuh"

namespace {

using namespace devo;

struct BandFront {
  const __nv_bfloat16* ring;   // (MEM, NBX, Hp, 24, C)
  const int* slot;
  const int* band;
  const int* y0;
  const int* nlive;            // (1,), on the device
  int nbx, hp;

  __device__ const __nv_bfloat16* row(int e, int r) const {
    const size_t at = (static_cast<size_t>(__ldg(slot + e)) * nbx + __ldg(band + e)) * hp +
                      __ldg(y0 + e) + r;
    return ring + at * window_probe::kCols * window_probe::kC;
  }
  __device__ bool live(int first) const { return first < __ldg(nlive); }
};

template <int kMode>
int launch_mode(const BandFront& f, const void* g, const void* ry,
                const void* rx, void* out, int E, int run, int depth,
                cudaStream_t st) {
  return window_probe::launch<BandFront, kMode>(f, g, ry, rx, out, E, run,
                                                depth, st);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. nlive (1,) int32; slot, band, y0 (E,) int32; g
// (E, 16, 128) bf16; ry, rx (E, 16) int32; ring (MEM, nbx, hp, 24, 128) bf16,
// 16-byte aligned; out (E, 8, 144) f32. `run` (64, the live gate's block) is
// the edges a block walks, `depth` (2 .. 4) the stages of the window ring,
// `mode` 0 = full, 1 = noext, 2 = nomm, 3 = noDMA. The dynamic shared memory
// taken is that of ops/probe_cuda.window_smem_bytes.
extern "C" int devo_corr_band_ablate(const void* nlive, const void* slot,
                                     const void* band, const void* y0,
                                     const void* g, const void* ry,
                                     const void* rx, const void* ring,
                                     void* out, int E, int nbx, int hp,
                                     int run, int depth, int mode,
                                     void* stream) {
  const BandFront f{static_cast<const __nv_bfloat16*>(ring),
                    static_cast<const int*>(slot), static_cast<const int*>(band),
                    static_cast<const int*>(y0), static_cast<const int*>(nlive),
                    nbx, hp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case window_probe::kFull:
      return launch_mode<window_probe::kFull>(f, g, ry, rx, out, E, run, depth, st);
    case window_probe::kNoExt:
      return launch_mode<window_probe::kNoExt>(f, g, ry, rx, out, E, run, depth, st);
    case window_probe::kNoMM:
      return launch_mode<window_probe::kNoMM>(f, g, ry, rx, out, E, run, depth, st);
    case window_probe::kNoDMA:
      return launch_mode<window_probe::kNoDMA>(f, g, ry, rx, out, E, run, depth, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
