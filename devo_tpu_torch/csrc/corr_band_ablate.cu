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
// The live gate is the TPU kernel's: the edges of a block of BE = 64 are
// computed if its first edge lies below nlive[0], which the kernel reads on
// the device (the host never does); no block writes the rows past them.
//
// What bounds it on an H100: at the driver's point (6144 live edges) the
// bytes, 98 KB of window, 4 KB of patch rows and 4.6 KB of output an edge,
// about 0.66 GB or 0.2 ms at 3.35 TB/s (the bound, 0.13 ms, counts the
// distinct ring rows of overlapping windows once), against 9.7 GFLOP of
// products (0.01 ms at the bf16 tensor-core rate). The design
// (csrc/window_probe.cuh) keeps the TPU kernel's loop, a ring of window
// stages filled ahead of the products, in chunks of 32 channels so that two
// blocks share an SM, and multiplies on the tensor cores: persistent
// blocks over the live edges, whose count the kernel works out from
// nlive[0] on the device, each edge alone (groups of one), so that every
// mode keeps every copy and product it measures. Measured on an H100 80GB
// HBM3 at 700 W (random layout, chip_smoke.py): "full" about 0.24 ms,
// "nomm" (the copies alone) 0.22, "noDMA" (the products alone) 0.08-0.09:
// the copies of the windows bound it, about 2.8 TB/s of window rows from
// device memory. Their L2 fetch hint matters here: a vector's four chunks
// are copied at four steps, and without it reach device memory as four
// requests far apart in time.

#include "window_probe.cuh"

namespace {

using namespace devo;

constexpr int kGate = 64;      // edges of the live gate's block (BE)

struct BandFront {
  const __nv_bfloat16* ring;   // (MEM, NBX, Hp, 24, C)
  const int* slot;
  const int* band;
  const int* y0;
  const int* nlive;            // (1,), on the device
  int nbx, hp;
  // a window's rows are consecutive rows of its band
  static constexpr size_t row_stride = window_probe::kCols * window_probe::kC;

  // the edges of the blocks of kGate whose first edge lies below nlive[0],
  // in their own order
  __device__ int edges(int E) const {
    const long long n = max(__ldg(nlive), 0);
    return static_cast<int>(min(static_cast<long long>(E),
                                (n + kGate - 1) / kGate * kGate));
  }
  __device__ size_t edge(int j) const { return j; }
  __device__ const __nv_bfloat16* origin(size_t e) const {
    const size_t at =
        (static_cast<size_t>(__ldg(slot + e)) * nbx + __ldg(band + e)) * hp +
        __ldg(y0 + e);
    return ring + at * row_stride;
  }
};

template <int kMode>
int launch_mode(const BandFront& f, const void* g, const void* ry,
                const void* rx, void* out, int E, int grid, int depth,
                cudaStream_t st) {
  return window_probe::launch<BandFront, kMode, 1>(f, g, ry, rx, out, E, grid,
                                                   depth, st);
}

template <int kMode>
int occupancy(int depth) {
  return window_probe::blocks_per_sm<BandFront, kMode, 1>(depth);
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. nlive (1,) int32; slot, band, y0 (E,) int32; g
// (E, 16, 128) bf16; ry, rx (E, 16) int32; ring (MEM, nbx, hp, 24, 128) bf16,
// 16-byte aligned; out (E, 8, 144) f32, whose rows past the live gate are
// left unwritten. `grid` is the number of persistent blocks (at most one an
// edge is launched), `depth` (2 .. 4) the stages of the window ring, `mode`
// 0 = full, 1 = noext, 2 = nomm, 3 = noDMA. The dynamic shared memory taken
// is that of ops/probe_cuda.window_smem_bytes (devo_corr_band_ablate_smem).
extern "C" int devo_corr_band_ablate(const void* nlive, const void* slot,
                                     const void* band, const void* y0,
                                     const void* g, const void* ry,
                                     const void* rx, const void* ring,
                                     void* out, int E, int nbx, int hp,
                                     int grid, int depth, int mode,
                                     void* stream) {
  const BandFront f{static_cast<const __nv_bfloat16*>(ring),
                    static_cast<const int*>(slot), static_cast<const int*>(band),
                    static_cast<const int*>(y0), static_cast<const int*>(nlive),
                    nbx, hp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case window_probe::kFull:
      return launch_mode<window_probe::kFull>(f, g, ry, rx, out, E, grid, depth, st);
    case window_probe::kNoExt:
      return launch_mode<window_probe::kNoExt>(f, g, ry, rx, out, E, grid, depth, st);
    case window_probe::kNoMM:
      return launch_mode<window_probe::kNoMM>(f, g, ry, rx, out, E, grid, depth, st);
    case window_probe::kNoDMA:
      return launch_mode<window_probe::kNoDMA>(f, g, ry, rx, out, E, grid, depth, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory devo_corr_band_ablate takes at `depth` stages.
extern "C" long long devo_corr_band_ablate_smem(int depth) {
  return static_cast<long long>(window_probe::smem_bytes(depth, 1));
}

// Blocks of devo_corr_band_ablate's kernel in `mode` that one SM of the
// current device holds at `depth` stages, or minus the cudaError_t of the
// query.
extern "C" int devo_corr_band_ablate_blocks_per_sm(int mode, int depth) {
  switch (mode) {
    case window_probe::kFull: return occupancy<window_probe::kFull>(depth);
    case window_probe::kNoExt: return occupancy<window_probe::kNoExt>(depth);
    case window_probe::kNoMM: return occupancy<window_probe::kNoMM>(depth);
    case window_probe::kNoDMA: return occupancy<window_probe::kNoDMA>(depth);
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
}
