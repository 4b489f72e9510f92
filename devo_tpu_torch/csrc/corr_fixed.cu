// One pyramid level of the sparse patch correlation over a fixed 16x24 window
// an edge, for Hopper (sm_90a): CORR_IMPL="pallas". Plain C interface, loaded
// with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel` (devo_tpu/ops/corr_pallas.py:63, reached
// through corr_level_pallas :111, pallas_call at :189, and
// corr_pyramid_pallas :199) together with its XLA glue: the zero-padded copy
// of the ring made at every call (:161-162), the index preamble (:136-144) and
// ops/corr.blend_strips. What that kernel is: per edge one window of 16 rows x
// 24 columns of feature vectors, its x origin aligned down to 8, copied into
// VMEM; one (384, C) x (C, 16) product of the window against the patch's
// pixels; each pixel's 8x16 tap strip read from that product surface. This
// kernel keeps the fixed window and the surface, and none of the TPU's
// shapes: it reads the plain, unpadded (mem, h, w, C) ring with a bounds
// test (off-image vectors are zero, no padded copy is built), takes the
// patch feature straight from gmap[kk], and blends in-kernel.
//
// What it computes, per edge e (one block each), with coords already at this
// level's resolution: ops/corr.corr_level, unclipped.
//   window  origin (wy0, wx0) = as devo_tpu places it, in ring coordinates:
//           oy = clamp(min y0 - 3 + 12, 0, h + 8), ox = clamp(min x0 - 3 + 12,
//           0, w) aligned down to 8, (wy0, wx0) = (oy - 12, ox - 12), over the
//           pixels' floors (x0, y0)
//   surface s[pos][p] = <gmap[kk[e]][p], fmap[jj[e], wy0 + pos / 24,
//           wx0 + pos % 24]>, f32, 0 off the image, for all 384 positions
//   taps    pixel p's 8x8 grid from the surface where it lies in the window;
//           a pixel whose grid leaves the window (a patch spread beyond 8 px,
//           or coordinates far off the image, whose window is clamped to the
//           ring's border) reads its 64 taps from the ring, one dot a tap, so
//           nothing is clipped
//   out     the 7x7 bilinear blend, (E, 49*P*P) f32 in [dx, dy, pixel] order.
//
// What bounds it on an H100: not the bytes. The fixed window is about four
// times the ~100 positions an undistorted patch's taps touch, so the kernel
// reads ~98 KB of bf16 ring an edge (the function needs ~25 KB) and does
// 384 x 9 x C multiply-adds (the function needs 64 x 9 x C): the
// multiply-adds and the shared-memory traffic that feeds them the patch
// feature bound it, as they bound csrc/corr_mono3.cu. What the design does:
//   - the trap of the TPU's schedule is the window itself, 96 KB of bf16 at
//     C = 128: staged whole it would leave two blocks an SM. Here the window
//     is not staged at all: a thread takes two positions, rows r and r + 8
//     of one column, and reads their vectors from the ring (through L1)
//     straight into registers, each once, four channels at a time;
//   - the patch feature, the only operand every thread needs, is held in
//     shared memory as f32 and read by all lanes at one address (a
//     broadcast): each value read serves the thread's two positions, which
//     halves that traffic against one position a thread;
//   - the surface, 384 x P*P f32 (13.5 KB), stays in shared memory; after
//     one barrier the block extracts, blends and writes the edge's row. 192
//     threads and 21 KB a block let ten blocks share an SM.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kRows = 16;                  // window rows
constexpr int kCols = 24;                  // window columns
constexpr int kBorder = 12;                // devo_tpu's zero border
constexpr int kPositions = kRows * kCols;
constexpr int kThreads = kPositions / 2;   // two positions a thread
constexpr int kTapCount = kTaps * kTaps;

// acc0[p], acc1[p] = <g[p], v0>, <g[p], v1> for p < n <= N: the products of
// two window positions with the patch's pixels, one read of each value of the
// patch feature (f32, shared memory) for both. v0 / v1 are ring vectors
// (device memory); a position off the image reads `v` of another, valid one
// and is zeroed by its flag afterwards.
template <int N, typename F>
__device__ __forceinline__ void two_positions(const float* g, const F* v0,
                                              const F* v1, int C, int n,
                                              float (&acc0)[N],
                                              float (&acc1)[N]) {
#pragma unroll
  for (int p = 0; p < N; ++p) { acc0[p] = 0.0f; acc1[p] = 0.0f; }
  for (int c = 0; c < C; c += kVec) {
    float a[kVec], b[kVec];
    load4(v0 + c, a);
    load4(v1 + c, b);
#pragma unroll
    for (int p = 0; p < N; ++p) {
      if (p < n) {
        const float4 gv = *reinterpret_cast<const float4*>(g + p * C + c);
        acc0[p] = fmaf(gv.x, a[0], acc0[p]);
        acc0[p] = fmaf(gv.y, a[1], acc0[p]);
        acc0[p] = fmaf(gv.z, a[2], acc0[p]);
        acc0[p] = fmaf(gv.w, a[3], acc0[p]);
        acc1[p] = fmaf(gv.x, b[0], acc1[p]);
        acc1[p] = fmaf(gv.y, b[1], acc1[p]);
        acc1[p] = fmaf(gv.z, b[2], acc1[p]);
        acc1[p] = fmaf(gv.w, b[3], acc1[p]);
      }
    }
  }
}

// this thread's two positions of the surface: rows r and r + 8, column c
template <int N, typename F>
__device__ __forceinline__ void surface_pair(float* surf, const float* g,
                                             const F* fbase, int wy0, int wx0,
                                             int H, int W, int C, int PP,
                                             int tid) {
  const int r = tid / kCols, c = tid % kCols;
  const int ix = wx0 + c;
  const int iy0 = wy0 + r, iy1 = iy0 + kRows / 2;
  const bool col = ix >= 0 && ix < W;
  const bool ok0 = col && iy0 >= 0 && iy0 < H;
  const bool ok1 = col && iy1 >= 0 && iy1 < H;
  // a position off the image reads the other one's vector, or the slot's
  // first, and its products are replaced by zeros
  const size_t at0 = ok0 ? (static_cast<size_t>(iy0) * W + ix) * C : 0;
  const size_t at1 = ok1 ? (static_cast<size_t>(iy1) * W + ix) * C : at0;
  float acc0[N], acc1[N];
  two_positions<N>(g, fbase + (ok0 ? at0 : at1), fbase + at1, C, PP, acc0,
                   acc1);
  float* d0 = surf + tid * PP;
  float* d1 = surf + (tid + kThreads) * PP;
#pragma unroll
  for (int p = 0; p < N; ++p) {
    if (p < PP) {
      d0[p] = ok0 ? acc0[p] : 0.0f;
      d1[p] = ok1 ? acc1[p] : 0.0f;
    }
  }
}

// F: type of the patch features and of the ring (bf16 or f32)
template <typename F>
__global__ void __launch_bounds__(kThreads)
corr_fixed_kernel(const F* __restrict__ gmap, const F* __restrict__ fmap,
                  const float* __restrict__ coords, const int* __restrict__ kk,
                  const int* __restrict__ jj, float* __restrict__ out, int PP,
                  int C, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* g = reinterpret_cast<float*>(smem_raw);     // (PP, C) patch feature
  float* surf = g + PP * C;                          // (384, PP) surface
  float* taps = surf + kPositions * PP;              // (PP, 8, 8) direct taps
  __shared__ int x0[kMaxPP], y0[kMaxPP], inside[kMaxPP];
  __shared__ float fx[kMaxPP], fy[kMaxPP];
  __shared__ int origin[2];

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const F* gsrc = gmap + static_cast<size_t>(kk[e]) * PP * C;
  for (int i = tid * kVec; i < PP * C; i += kThreads * kVec) {
    float v[kVec];
    load4(gsrc + i, v);
    *reinterpret_cast<float4*>(g + i) = make_float4(v[0], v[1], v[2], v[3]);
  }
  const float* ce = coords + static_cast<size_t>(e) * PP * 2;
  if (tid < PP) {
    const float x = ce[2 * tid], y = ce[2 * tid + 1];
    x0[tid] = floor_index(x);
    y0[tid] = floor_index(y);
    fx[tid] = x - floorf(x);
    fy[tid] = y - floorf(y);
  }
  __syncthreads();
  if (tid == 0) {
    int xmin = 0x7fffffff, ymin = 0x7fffffff;
    for (int p = 0; p < PP; ++p) {
      xmin = min(xmin, x0[p]);
      ymin = min(ymin, y0[p]);
    }
    // as devo_tpu's corr_level_pallas (:137-140): in the ring bordered by
    // 12, clamped so that the window fits, x aligned down to 8
    const int ox = min(max(xmin - kRadius + kBorder, 0), W) / 8 * 8;
    const int oy = min(max(ymin - kRadius + kBorder, 0), H + 2 * kBorder - kRows);
    origin[0] = oy - kBorder;
    origin[1] = ox - kBorder;
  }
  __syncthreads();
  const int wy0 = origin[0], wx0 = origin[1];
  if (tid < PP) {
    const int ry = y0[tid] - kRadius - wy0, rx = x0[tid] - kRadius - wx0;
    inside[tid] = ry >= 0 && ry + kTaps <= kRows && rx >= 0 && rx + kTaps <= kCols;
  }

  const F* fbase = fmap + static_cast<size_t>(jj[e]) * H * W * C;
  if (PP == 9)
    surface_pair<9>(surf, g, fbase, wy0, wx0, H, W, C, PP, tid);
  else
    surface_pair<kMaxPP>(surf, g, fbase, wy0, wx0, H, W, C, PP, tid);
  __syncthreads();

  // the taps of pixels whose grid leaves the window, one dot a tap
  const int start = (kVec * lane) % C;
  for (int it = tid; it < PP * kTapCount; it += kThreads) {
    const int p = it / kTapCount;
    if (inside[p]) continue;
    const int tap = it - p * kTapCount;
    const int iy = y0[p] + tap / kTaps - kRadius;
    const int ix = x0[p] + tap % kTaps - kRadius;
    taps[it] = (iy < 0 || iy >= H || ix < 0 || ix >= W)
                   ? 0.0f
                   : dot_rotated(g + p * C,
                                 fbase + (static_cast<size_t>(iy) * W + ix) * C,
                                 C, start);
  }
  __syncthreads();

  // extraction and blend: out[e][(ox * 7 + oy) * PP + p]
  const int n_out = kOut * kOut * PP;
  float* dst = out + static_cast<size_t>(e) * n_out;
  for (int o = tid; o < n_out; o += kThreads) {
    const int p = o % PP;
    const int t = o / PP;
    const int ox = t / kOut, oy = t - ox * kOut;
    if (inside[p]) {
      const int r = y0[p] - kRadius - wy0 + oy;
      const int c = x0[p] - kRadius - wx0 + ox;
      const float* s = surf + (r * kCols + c) * PP + p;
      const float a = fx[p], b = fy[p];
      dst[o] = (1.0f - a) * (1.0f - b) * s[0] + a * (1.0f - b) * s[PP] +
               (1.0f - a) * b * s[kCols * PP] + a * b * s[(kCols + 1) * PP];
    } else {
      dst[o] = blend_frac(taps + p * kTapCount, ox, oy, fx[p], fy[p]);
    }
  }
}

template <typename F>
int launch(const void* gmap, const void* fmap, const void* coords,
           const void* kk, const void* jj, void* out, int E, int PP, int C,
           int H, int W, cudaStream_t st) {
  const size_t smem =
      (static_cast<size_t>(PP) * C + (kPositions + kTapCount) * PP) * sizeof(float);
  const cudaError_t err = allow_shared_memory(corr_fixed_kernel<F>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_fixed_kernel<F><<<E, kThreads, smem, st>>>(
      static_cast<const F*>(gmap), static_cast<const F*>(fmap),
      static_cast<const float*>(coords), static_cast<const int*>(kk),
      static_cast<const int*>(jj), static_cast<float*>(out), PP, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous
// tensors: gmap (Mring, P, P, C) and fmap (mem, H, W, C), both bf16 if bf16
// else f32; coords (E, P, P, 2) f32 at this level's resolution; kk / jj (E,)
// int32 ring indices; out (E, 49*P*P) f32. C is a multiple of 4, P*P at
// most 16. The shared memory taken is that of
// ops/corr_cuda.fixed_smem_bytes.
extern "C" int devo_corr_fixed(const void* gmap, const void* fmap,
                               const void* coords, const void* kk,
                               const void* jj, void* out, int E, int PP, int C,
                               int H, int W, int bf16, void* stream) {
  if (E == 0) return 0;
  if (PP > kMaxPP) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(gmap, fmap, coords, kk, jj, out, E, PP,
                                      C, H, W, st)
              : launch<float>(gmap, fmap, coords, kk, jj, out, E, PP, C, H, W,
                              st);
}
