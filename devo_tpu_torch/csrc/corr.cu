// Two-level sparse patch correlation for the DEVO tracking step, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_mono`
// (devo_tpu/ops/corr_pallas.py:1553, reached through corr_pyramid_banded
// :1962 -> corr_pyramid_pair2 :1835, pallas_call at :1944) together with its
// XLA glue: lookup_g (:968), _pair_level_index (:1195), the banded ring
// writes band_frame / band_frame_i8 (:242, :266) and ops/corr.blend_strips
// (devo_tpu/ops/corr.py:180). It computes the function, not the TPU
// schedule: plain (mem, h, w, C) rings, no banding, stagger or window clip.
//
// What it computes, per edge e (one block each):
//   g      = gmap[kk[e]]                       (P*P pixels x C)
//   level  l in {0, 1}: fmap = l ? fmap2 : fmap1, coords / scale_l
//   taps   t[l][p][di][dj] = <g[p], fmap[jj[e], y0+di-3, x0+dj-3]>, 8x8 integer
//          grid around floor(coord of pixel p); out-of-bounds taps are 0
//   out    the 7x7 bilinear blend of the taps with the fractional offsets,
//          written as (E, 2*49*P*P) f32 in [dx, dy, pixel, level] order
//          (ops/corr.corr_pyramid).
// Accumulation is f32; the features may be f32 or bf16.
//
// Cost per edge at P=3, C=128: 2 levels x 9 pixels x 64 taps x C multiply-
// adds = 2 * 9 * 64 * 128 * 2 ~= 295k FLOP, and the window reads: the 3x3
// patch's 8x8 tap grids cover about 10x10 feature rows per level, ~25 KB of
// bf16 at level 1 and a few KB at level 4 (a few tens of KB per edge).
//
// What bounds it on an H100: the window reads. At 480x640 the level-1 ring
// (32 x 120 x 160 x 128 bf16) is ~157 MB and does not fit the 50 MB L2, so
// level-1 windows come from device memory; the level-4 ring (~10 MB) stays
// in L2. The FLOPs are far below the tensor-core rate and this first
// version uses none: one warp per tap, one dot of C with 2 channels per lane
// and a shuffle reduction, the patch feature held in shared memory as f32.
// The 9 pixels' overlapping windows hit L1 after the first touch. A faster
// design (window tiles by TMA, the 9xC by C-x-window product on wgmma) is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRadius = 3;
constexpr int kTaps = 2 * kRadius + 2;     // 8x8 integer taps
constexpr int kOut = 2 * kRadius + 1;      // 7x7 blended offsets
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// floor of a coordinate as an int; far-off values are clamped first (they
// are out of bounds either way) so the conversion cannot overflow
__device__ __forceinline__ int floor_index(float v) {
  return static_cast<int>(floorf(fminf(fmaxf(v, -1.0e6f), 1.0e6f)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
corr_pyramid_kernel(const T* __restrict__ gmap, const T* __restrict__ fmap1,
                    const T* __restrict__ fmap2,
                    const float* __restrict__ coords,
                    const int* __restrict__ kk, const int* __restrict__ jj,
                    float* __restrict__ out, int PP, int C, int h1, int w1,
                    int h2, int w2, float scale1, float scale2) {
  extern __shared__ float smem[];
  float* g = smem;                    // (PP, C) patch feature
  float* taps = smem + PP * C;        // (2, PP, 8, 8) integer-tap dots

  const int e = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const T* gsrc = gmap + static_cast<size_t>(kk[e]) * PP * C;
  for (int i = threadIdx.x; i < PP * C; i += kThreads) g[i] = to_float(gsrc[i]);
  __syncthreads();

  const int frame = jj[e];
  const float* ce = coords + static_cast<size_t>(e) * PP * 2;
  const int per_level = PP * kTaps * kTaps;

  for (int it = warp; it < 2 * per_level; it += kWarps) {
    const int lvl = it / per_level;
    const int rem = it - lvl * per_level;
    const int p = rem / (kTaps * kTaps);
    const int tap = rem - p * kTaps * kTaps;
    const float s = lvl ? scale2 : scale1;
    const int H = lvl ? h2 : h1;
    const int W = lvl ? w2 : w1;
    const int iy = floor_index(ce[2 * p + 1] / s) + tap / kTaps - kRadius;
    const int ix = floor_index(ce[2 * p] / s) + tap % kTaps - kRadius;
    float acc = 0.0f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {   // uniform across the warp
      const T* f = (lvl ? fmap2 : fmap1) +
                   ((static_cast<size_t>(frame) * H + iy) * W + ix) * C;
      const float* gp = g + p * C;
      for (int c = 2 * lane; c < C; c += 64) {
        const float2 fv = load_pair(f + c);
        acc = fmaf(gp[c], fv.x, acc);
        acc = fmaf(gp[c + 1], fv.y, acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) taps[it] = acc;
  }
  __syncthreads();

  // bilinear blend: out[e][((ox * 7 + oy) * PP + p) * 2 + lvl]
  const int n_out = 2 * kOut * kOut * PP;
  float* dst = out + static_cast<size_t>(e) * n_out;
  for (int o = threadIdx.x; o < n_out; o += kThreads) {
    const int lvl = o & 1;
    const int q = o >> 1;
    const int p = q % PP;
    const int t = q / PP;
    const int oy = t % kOut;
    const int ox = t / kOut;
    const float s = lvl ? scale2 : scale1;
    const float x = ce[2 * p] / s;
    const float y = ce[2 * p + 1] / s;
    const float fx = x - floorf(x);
    const float fy = y - floorf(y);
    const float* tp = taps + (lvl * PP + p) * kTaps * kTaps + oy * kTaps + ox;
    dst[o] = (1.0f - fx) * (1.0f - fy) * tp[0] + fx * (1.0f - fy) * tp[1] +
             (1.0f - fx) * fy * tp[kTaps] + fx * fy * tp[kTaps + 1];
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous
// tensors: gmap (Mring, P, P, C), fmap1 (mem, h1, w1, C), fmap2
// (mem, h2, w2, C) of one dtype (bf16 if is_bf16, else f32), coords
// (E, P, P, 2) f32, kk / jj (E,) int32 ring indices, out (E, 2*49*P*P) f32.
extern "C" int devo_corr_pyramid(const void* gmap, const void* fmap1,
                                 const void* fmap2, const void* coords,
                                 const void* kk, const void* jj, void* out,
                                 int E, int PP, int C, int h1, int w1, int h2,
                                 int w2, float scale1, float scale2,
                                 int is_bf16, void* stream) {
  if (E == 0) return 0;
  const size_t smem = (static_cast<size_t>(PP) * C + 2 * PP * kTaps * kTaps) *
                      sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(coords);
  const int* k = static_cast<const int*>(kk);
  const int* j = static_cast<const int*>(jj);
  float* o = static_cast<float*>(out);
  if (is_bf16) {
    using T = __nv_bfloat16;
    corr_pyramid_kernel<T><<<E, kThreads, smem, st>>>(
        static_cast<const T*>(gmap), static_cast<const T*>(fmap1),
        static_cast<const T*>(fmap2), c, k, j, o, PP, C, h1, w1, h2, w2,
        scale1, scale2);
  } else {
    corr_pyramid_kernel<float><<<E, kThreads, smem, st>>>(
        static_cast<const float*>(gmap), static_cast<const float*>(fmap1),
        static_cast<const float*>(fmap2), c, k, j, o, PP, C, h1, w1, h2, w2,
        scale1, scale2);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* devo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
