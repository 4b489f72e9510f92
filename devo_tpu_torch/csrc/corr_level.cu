// One pyramid level of the sparse patch correlation per launch, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_split`
// (devo_tpu/ops/corr_pallas.py:356, reached through corr_level_banded :738,
// pallas_call at :857, ablate="split") together with its XLA glue: lookup_g
// (:968), the index preamble (:784-810), the one-hot scale lookup (:824-826)
// and ops/corr.blend_strips. It computes the function, not the TPU schedule:
// plain (mem, h, w, C) rings, no bands, stagger, 24-wide windows or window
// clip; out-of-image taps read zero by a bounds check.
//
// What it computes, per edge e (one block each), with coords already at this
// level's resolution:
//   g     = gmap[kk[e]]                              (P*P pixels x C)
//   taps  t[p][di][dj] = <g[p], fmap[jj[e], y0+di-3, x0+dj-3]>, the 8x8
//         integer grid around floor(coord of pixel p); with an int8 ring the
//         dot is over the integer values, times the slot's scale dq[jj[e]]
//   out   the 7x7 bilinear blend, (E, 49*P*P) f32 in [dx, dy, pixel] order
//         (ops/corr.corr_level).
// Accumulation is f32.
//
// What bounds it on an H100: bytes, by a wide margin over its arithmetic
// (147k FLOP an edge against a window of ~100 feature vectors), and below
// the byte bound the latency of many small dependent reads. What the design
// does about it, differently from csrc/corr.cu's one warp per tap:
//   - the patch's covering window (the union of the 9 pixels' 8x8 grids,
//     about 10x10 vectors: 12.8 KB int8, 25.6 KB bf16 at C = 128) is copied
//     once into shared memory with 16-byte loads, so every feature vector
//     leaves device memory or L2 once per edge instead of up to 9 times;
//   - one thread per tap then takes the whole dot over C from shared memory
//     (no shuffle reduction): the lanes of a warp start at different
//     channels (dot_rotated) so that their vectors, C elements apart, fall
//     into different banks;
//   - an edge whose window exceeds the staging capacity (a strongly
//     distorted patch) reads its taps directly from the ring instead.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 128;

// G: type of the patch features, F: type of the ring
template <typename G, typename F>
__global__ void __launch_bounds__(kThreads)
corr_level_kernel(const G* __restrict__ gmap, const F* __restrict__ fmap,
                  const float* __restrict__ dq,
                  const float* __restrict__ coords,
                  const int* __restrict__ kk, const int* __restrict__ jj,
                  float* __restrict__ out, int PP, int C, int H, int W,
                  int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* g = reinterpret_cast<float*>(smem_raw);      // (PP, C) patch feature
  float* taps = g + PP * C;                           // (PP, 8, 8) tap dots
  F* win = reinterpret_cast<F*>(taps + PP * kTaps * kTaps);  // (cap, C)

  const int e = blockIdx.x;
  const int lane = threadIdx.x & 31;

  const G* gsrc = gmap + static_cast<size_t>(kk[e]) * PP * C;
  for (int i = threadIdx.x; i < PP * C; i += kThreads) g[i] = to_float(gsrc[i]);

  // the window that covers every pixel's tap grid
  const float* ce = coords + static_cast<size_t>(e) * PP * 2;
  int xmin = 0x7fffffff, xmax = -0x7fffffff, ymin = xmin, ymax = xmax;
  for (int p = 0; p < PP; ++p) {
    const int x0 = floor_index(ce[2 * p]);
    const int y0 = floor_index(ce[2 * p + 1]);
    xmin = min(xmin, x0); xmax = max(xmax, x0);
    ymin = min(ymin, y0); ymax = max(ymax, y0);
  }
  const int ww = xmax - xmin + kTaps;
  const int wh = ymax - ymin + kTaps;
  const int wx0 = xmin - kRadius;
  const int wy0 = ymin - kRadius;
  const bool staged = static_cast<long long>(ww) * wh <= cap;

  const int frame = jj[e];
  const F* fbase = fmap + static_cast<size_t>(frame) * H * W * C;

  if (staged) {
    constexpr int kChunk = 16 / sizeof(F);    // elements per 16-byte copy
    const int chunks = C / kChunk;            // per feature vector
    for (int i = threadIdx.x; i < ww * wh * chunks; i += kThreads) {
      const int pos = i / chunks;
      const int ch = (i - pos * chunks) * kChunk;
      const int r = pos / ww;
      const int iy = wy0 + r;
      const int ix = wx0 + pos - r * ww;
      // positions off the image stay unwritten: no tap reads them
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        *reinterpret_cast<uint4*>(win + static_cast<size_t>(pos) * C + ch) =
            *reinterpret_cast<const uint4*>(
                fbase + (static_cast<size_t>(iy) * W + ix) * C + ch);
    }
  }
  __syncthreads();

  const float q = dq ? dq[frame] : 1.0f;
  const int start = (kVec * lane) % C;
  const int n_taps = PP * kTaps * kTaps;
  for (int it = threadIdx.x; it < n_taps; it += kThreads) {
    const int p = it / (kTaps * kTaps);
    const int tap = it - p * kTaps * kTaps;
    const int iy = floor_index(ce[2 * p + 1]) + tap / kTaps - kRadius;
    const int ix = floor_index(ce[2 * p]) + tap % kTaps - kRadius;
    float acc = 0.0f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      const float* gp = g + p * C;
      if (staged)
        acc = dot_rotated(
            gp, win + static_cast<size_t>((iy - wy0) * ww + (ix - wx0)) * C,
            C, start);
      else
        acc = dot_rotated(gp, fbase + (static_cast<size_t>(iy) * W + ix) * C,
                          C, start);
    }
    taps[it] = acc * q;
  }
  __syncthreads();

  // bilinear blend: out[e][(ox * 7 + oy) * PP + p]
  const int n_out = kOut * kOut * PP;
  float* dst = out + static_cast<size_t>(e) * n_out;
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    const int p = o % PP;
    const int t = o / PP;
    dst[o] = blend_tap(taps + p * kTaps * kTaps, t / kOut, t % kOut,
                       ce[2 * p], ce[2 * p + 1]);
  }
}

template <typename G, typename F>
int launch(const void* gmap, const void* fmap, const void* dq,
           const void* coords, const void* kk, const void* jj, void* out,
           int E, int PP, int C, int H, int W, int cap, cudaStream_t st) {
  const size_t smem =
      (static_cast<size_t>(PP) * C + PP * kTaps * kTaps) * sizeof(float) +
      static_cast<size_t>(cap) * C * sizeof(F);
  const cudaError_t err =
      allow_shared_memory(corr_level_kernel<G, F>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_level_kernel<G, F><<<E, kThreads, smem, st>>>(
      static_cast<const G*>(gmap), static_cast<const F*>(fmap),
      static_cast<const float*>(dq), static_cast<const float*>(coords),
      static_cast<const int*>(kk), static_cast<const int*>(jj),
      static_cast<float*>(out), PP, C, H, W, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C), bf16 if g_bf16 else f32;
// fmap (mem, H, W, C) of gmap's type, or int8 if ring_i8, and then dq (mem,)
// f32 holds the slots' scales (null otherwise); coords (E, P, P, 2) f32 at
// this level's resolution; kk / jj (E,) int32 ring indices; out (E, 49*P*P)
// f32. C is a multiple of 4. `cap` is the number of feature vectors of the
// staged window (0 = read every tap from the ring); a vector must then be a
// multiple of 16 bytes. The shared memory taken is that of
// ops/corr_cuda.level_smem_bytes.
extern "C" int devo_corr_level(const void* gmap, const void* fmap,
                               const void* dq, const void* coords,
                               const void* kk, const void* jj, void* out,
                               int E, int PP, int C, int H, int W, int cap,
                               int g_bf16, int ring_i8, void* stream) {
  if (E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(G, F) \
  launch<G, F>(gmap, fmap, dq, coords, kk, jj, out, E, PP, C, H, W, cap, st)
  if (g_bf16)
    return ring_i8 ? DEVO_LAUNCH(__nv_bfloat16, int8_t)
                   : DEVO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  return ring_i8 ? DEVO_LAUNCH(float, int8_t) : DEVO_LAUNCH(float, float);
#undef DEVO_LAUNCH
}
