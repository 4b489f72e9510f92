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
// Accumulation is f32. The patch features may be f32 or bf16; the rings are
// of the same type or int8 (the quantised-ring half of the TPU kernel, its
// `wi8` branch): the dot is then taken over the integer values and the ring
// slot's dequantisation scale dq_l[jj[e]] multiplies the tap, which is exact
// because the correlation is linear in the frame features.
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
// version uses none: one warp per tap, one dot of C with 4 channels per lane
// (16, 8 or 4 bytes by ring type) and a shuffle reduction, the patch feature
// held in shared memory as f32. int8 rings halve the window bytes.
// The 9 pixels' overlapping windows hit L1 after the first touch. A faster
// design (window tiles by TMA, the 9xC by C-x-window product on wgmma) is
// later work.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// G: type of the patch features, F: type of the rings (G or int8_t)
template <typename G, typename F>
__global__ void __launch_bounds__(kThreads)
corr_pyramid_kernel(const G* __restrict__ gmap, const F* __restrict__ fmap1,
                    const F* __restrict__ fmap2,
                    const float* __restrict__ dq1,
                    const float* __restrict__ dq2,
                    const float* __restrict__ coords,
                    const int* __restrict__ kk, const int* __restrict__ jj,
                    float* __restrict__ out, int PP, int C, int h1, int w1,
                    int h2, int w2, float lvl1, float lvl2) {
  extern __shared__ __align__(16) float smem[];
  float* g = smem;                    // (PP, C) patch feature
  float* taps = smem + PP * C;        // (2, PP, 8, 8) integer-tap dots

  const int e = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const G* gsrc = gmap + static_cast<size_t>(kk[e]) * PP * C;
  for (int i = threadIdx.x; i < PP * C; i += kThreads) g[i] = to_float(gsrc[i]);
  __syncthreads();

  const int frame = jj[e];
  const float* ce = coords + static_cast<size_t>(e) * PP * 2;
  const int per_level = PP * kTaps * kTaps;
  // dequantisation scale of the edge's ring slot, per level (int8 rings)
  const float q1 = dq1 ? dq1[frame] : 1.0f;
  const float q2 = dq2 ? dq2[frame] : 1.0f;

  for (int it = warp; it < 2 * per_level; it += kWarps) {
    const int lvl = it / per_level;
    const int rem = it - lvl * per_level;
    const int p = rem / (kTaps * kTaps);
    const int tap = rem - p * kTaps * kTaps;
    const float s = lvl ? lvl2 : lvl1;
    const int H = lvl ? h2 : h1;
    const int W = lvl ? w2 : w1;
    const int iy = floor_index(ce[2 * p + 1] / s) + tap / kTaps - kRadius;
    const int ix = floor_index(ce[2 * p] / s) + tap % kTaps - kRadius;
    float acc = 0.0f;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {   // uniform across the warp
      const F* f = (lvl ? fmap2 : fmap1) +
                   ((static_cast<size_t>(frame) * H + iy) * W + ix) * C;
      const float* gp = g + p * C;
      for (int c = kVec * lane; c < C; c += 32 * kVec) {
        const float4 gv = *reinterpret_cast<const float4*>(gp + c);
        float v[kVec];
        load4(f + c, v);
        acc = fmaf(gv.x, v[0], acc);
        acc = fmaf(gv.y, v[1], acc);
        acc = fmaf(gv.z, v[2], acc);
        acc = fmaf(gv.w, v[3], acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
    }
    if (lane == 0) taps[it] = acc * (lvl ? q2 : q1);
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
    const float s = lvl ? lvl2 : lvl1;
    dst[o] = blend_tap(taps + (lvl * PP + p) * kTaps * kTaps, t / kOut,
                       t % kOut, ce[2 * p] / s, ce[2 * p + 1] / s);
  }
}

template <typename G, typename F>
int launch(const void* gmap, const void* fmap1, const void* fmap2,
           const void* dq1, const void* dq2, const void* coords,
           const void* kk, const void* jj, void* out, int E, int PP, int C,
           int h1, int w1, int h2, int w2, float lvl1, float lvl2,
           cudaStream_t st) {
  const size_t smem = (static_cast<size_t>(PP) * C + 2 * PP * kTaps * kTaps) *
                      sizeof(float);
  corr_pyramid_kernel<G, F><<<E, kThreads, smem, st>>>(
      static_cast<const G*>(gmap), static_cast<const F*>(fmap1),
      static_cast<const F*>(fmap2), static_cast<const float*>(dq1),
      static_cast<const float*>(dq2), static_cast<const float*>(coords),
      static_cast<const int*>(kk), static_cast<const int*>(jj),
      static_cast<float*>(out), PP, C, h1, w1, h2, w2, lvl1, lvl2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C), bf16 if g_bf16 else f32;
// fmap1 (mem, h1, w1, C) and fmap2 (mem, h2, w2, C), of gmap's type, or
// int8 if ring_i8, and then dq1, dq2 (mem,) f32 are the slots' scales (null
// otherwise); coords (E, P, P, 2) f32 at level-1 resolution, divided by
// lvl1 and lvl2 in the kernel; kk / jj (E,) int32 ring indices; out
// (E, 2*49*P*P) f32. C is a multiple of 4.
extern "C" int devo_corr_pyramid(const void* gmap, const void* fmap1,
                                 const void* fmap2, const void* dq1,
                                 const void* dq2, const void* coords,
                                 const void* kk, const void* jj, void* out,
                                 int E, int PP, int C, int h1, int w1, int h2,
                                 int w2, float lvl1, float lvl2, int g_bf16,
                                 int ring_i8, void* stream) {
  if (E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(G, F)                                                    \
  launch<G, F>(gmap, fmap1, fmap2, dq1, dq2, coords, kk, jj, out, E, PP, C,  \
               h1, w1, h2, w2, lvl1, lvl2, st)
  if (g_bf16)
    return ring_i8 ? DEVO_LAUNCH(__nv_bfloat16, int8_t)
                   : DEVO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  return ring_i8 ? DEVO_LAUNCH(float, int8_t) : DEVO_LAUNCH(float, float);
#undef DEVO_LAUNCH
}

extern "C" const char* devo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
