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
// What bounds it on an H100: not the function's bytes. The fixed window is
// about four times the ~100 positions an undistorted patch's taps touch, so
// the kernel reads ~98 KB of bf16 ring an edge (the function needs ~25 KB)
// and does 384 x 9 x C multiply-adds (the function needs 64 x 9 x C).
//
// bf16 rings: the (384 x C) x (C x 16) surface is a product on the tensor
// cores (corr_mma.cuh), and then the bytes that reach shared memory bound
// it. What the design does:
//   - the window is staged through shared memory in chunks of 32 channels
//     (384 positions x 64 bytes, 24 KB a stage) by cp.async, two stages
//     deep: the copies of chunk k+1 fly while the warps multiply chunk k,
//     one barrier a chunk. Only the positions that the inside pixels' grids
//     cover (their bounding rows and columns, about 11 x 11 of the 16 x 24
//     for an undistorted patch: ~31 KB an edge at C = 128 instead of 98)
//     are read from the ring; the others, those off the image and channels
//     past C are copied as zeros;
//   - 24 m-tiles of 16 positions, three a warp, two n-tiles of 8 pixels
//     (columns past the patch's pixels are zero), C/16 k-steps of
//     mma.sync.m16n8k16 (bf16 in, f32 sums); an m-tile none of whose
//     positions lies in the covered rows is skipped, its surface rows being
//     read by no tap. The patch feature is staged as bf16 once an edge and
//     each warp reads its B fragments from it;
//   - the accumulators go to the f32 surface (384 x P*P) in shared memory;
//     after one barrier the block extracts, blends and writes the edge's row.
//     256 threads and 68 KB a block: three blocks share an SM, and one
//     block's copies fly while the others multiply or extract (a third
//     stage, at two blocks an SM, was 13-16% slower on the card).
//
// f32 rings (MIXED_PRECISION=False), which the tensor cores would round:
// the multiply-adds and the shared-memory traffic that feeds them the patch
// feature bound it, as they bound the f32 rings of csrc/corr_pipe.cuh. What
// the design does:
//   - the window is not staged at all: a thread takes two positions, rows r
//     and r + 8 of one column, and reads their vectors from the ring (through
//     L1) straight into registers, each once, four channels at a time;
//   - the patch feature, the only operand every thread needs, is held in
//     shared memory as f32 and read by all lanes at one address (a
//     broadcast): each value read serves the thread's two positions, which
//     halves that traffic against one position a thread;
//   - the surface, 384 x P*P f32 (13.5 KB), stays in shared memory; after
//     one barrier the block extracts, blends and writes the edge's row. 192
//     threads and 21 KB a block let ten blocks share an SM.

#include <type_traits>

#include "corr_mma.cuh"

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

// An edge's pixels and its window, in shared memory: the floors and the
// fractions of the pixels' coordinates, the window's origin in ring
// coordinates, whether each pixel's 8x8 grid lies inside the window, and the
// rows r0 .. r1 and columns c0 .. c1 of the window that those grids cover
// (r0 > r1 where no pixel is inside).
struct FixedPrep {
  int x0[kMaxPP], y0[kMaxPP], inside[kMaxPP];
  float fx[kMaxPP], fy[kMaxPP];
  int wy0, wx0, r0, r1, c0, c1;
};

// Fill `fp` for the edge with coordinates ce (device memory): the first warp
// computes, one lane a pixel, and the block synchronises once.
__device__ __forceinline__ void place_window(FixedPrep& fp, const float* ce,
                                             int PP, int H, int W, int tid) {
  if (tid < 32) {
    const bool pixel = tid < PP;
    int x0 = 0, y0 = 0;
    if (pixel) {
      const float x = ce[2 * tid], y = ce[2 * tid + 1];
      x0 = floor_index(x);
      y0 = floor_index(y);
      fp.x0[tid] = x0;
      fp.y0[tid] = y0;
      fp.fx[tid] = x - floorf(x);
      fp.fy[tid] = y - floorf(y);
    }
    constexpr unsigned kAll = 0xffffffffu;
    const int xmin = __reduce_min_sync(kAll, pixel ? x0 : 0x7fffffff);
    const int ymin = __reduce_min_sync(kAll, pixel ? y0 : 0x7fffffff);
    // as devo_tpu's corr_level_pallas (:137-140): in the ring bordered by
    // 12, clamped so that the window fits, x aligned down to 8
    const int ox = min(max(xmin - kRadius + kBorder, 0), W) / 8 * 8;
    const int oy = min(max(ymin - kRadius + kBorder, 0), H + 2 * kBorder - kRows);
    const int wy0 = oy - kBorder, wx0 = ox - kBorder;
    const int ry = y0 - kRadius - wy0, rx = x0 - kRadius - wx0;
    const bool inside = pixel && ry >= 0 && ry + kTaps <= kRows && rx >= 0 &&
                        rx + kTaps <= kCols;
    if (pixel) fp.inside[tid] = inside;
    const int r0 = __reduce_min_sync(kAll, inside ? ry : kRows);
    const int r1 = __reduce_max_sync(kAll, inside ? ry + kTaps - 1 : -1);
    const int c0 = __reduce_min_sync(kAll, inside ? rx : kCols);
    const int c1 = __reduce_max_sync(kAll, inside ? rx + kTaps - 1 : -1);
    if (tid == 0) {
      fp.wy0 = wy0; fp.wx0 = wx0;
      fp.r0 = r0; fp.r1 = r1; fp.c0 = c0; fp.c1 = c1;
    }
  }
  __syncthreads();
}

// This thread's outputs o = tid + k * nthreads of an edge's row, decoded:
// o = (ox * 7 + oy) * PP + p, packed as p | oy << 4 | ox << 7 (-1 past the
// row).
constexpr int kMaxOuts = (kOut * kOut * kMaxPP + kThreads - 1) / kThreads;
__device__ __forceinline__ void decode_outputs(int (&outs)[kMaxOuts], int PP,
                                               int tid, int nthreads) {
#pragma unroll
  for (int k = 0; k < kMaxOuts; ++k) {
    const int o = tid + k * nthreads;
    const int t = o / PP;
    outs[k] = o < kOut * kOut * PP ? o % PP | (t % kOut) << 4 | (t / kOut) << 7
                                   : -1;
  }
}

// The taps of the pixels whose grid leaves the window, one dot a tap, into
// taps (PP, 8, 8): g (PP rows, gstride apart; f32 as dot_rotated takes it,
// or bf16) against the ring slot fbase.
template <typename G, typename F>
__device__ __forceinline__ void direct_taps(float* taps, const G* g,
                                            int gstride, const F* fbase,
                                            const FixedPrep& fp, int PP, int C,
                                            int H, int W, int tid,
                                            int nthreads) {
  const int start = (kVec * (tid & 31)) % C;
  auto dot = [&](const G* gp, const F* f) {
    if constexpr (std::is_same<G, float>::value)
      return dot_rotated(gp, f, C, start);
    else
      return dot_any(gp, f, C);
  };
  for (int it = tid; it < PP * kTapCount; it += nthreads) {
    const int p = it / kTapCount;
    if (fp.inside[p]) continue;
    const int tap = it - p * kTapCount;
    const int iy = fp.y0[p] + tap / kTaps - kRadius;
    const int ix = fp.x0[p] + tap % kTaps - kRadius;
    taps[it] = (iy < 0 || iy >= H || ix < 0 || ix >= W)
                   ? 0.0f
                   : dot(g + static_cast<size_t>(p) * gstride,
                         fbase + (static_cast<size_t>(iy) * W + ix) * C);
  }
}

// Extraction and blend of the edge's row, out[(ox * 7 + oy) * PP + p], from
// the surface (position pos at surf + pos * ss) or the direct taps.
__device__ __forceinline__ void fixed_row(float* dst, const float* surf,
                                          int ss, const float* taps,
                                          const FixedPrep& fp,
                                          const int (&outs)[kMaxOuts], int tid,
                                          int nthreads) {
#pragma unroll
  for (int k = 0; k < kMaxOuts; ++k) {
    if (outs[k] < 0) continue;
    const int p = outs[k] & 15, oy = outs[k] >> 4 & 7, ox = outs[k] >> 7;
    const int o = tid + k * nthreads;
    if (fp.inside[p]) {
      const int r = fp.y0[p] - kRadius - fp.wy0 + oy;
      const int c = fp.x0[p] - kRadius - fp.wx0 + ox;
      dst[o] = blend_at(surf + (r * kCols + c) * ss + p, ss, kCols * ss,
                        fp.fx[p], fp.fy[p]);
    } else {
      dst[o] = blend_frac(taps + p * kTapCount, ox, oy, fp.fx[p], fp.fy[p]);
    }
  }
}

// f32 rings and patch features
__global__ void __launch_bounds__(kThreads)
corr_fixed_kernel(const float* __restrict__ gmap, const float* __restrict__ fmap,
                  const float* __restrict__ coords, const int* __restrict__ kk,
                  const int* __restrict__ jj, float* __restrict__ out, int PP,
                  int C, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* g = reinterpret_cast<float*>(smem_raw);     // (PP, C) patch feature
  float* surf = g + PP * C;                          // (384, PP) surface
  float* taps = surf + kPositions * PP;              // (PP, 8, 8) direct taps
  __shared__ FixedPrep fp;

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  int outs[kMaxOuts];
  decode_outputs(outs, PP, tid, kThreads);
  const float* gsrc = gmap + static_cast<size_t>(kk[e]) * PP * C;
  for (int i = tid * kVec; i < PP * C; i += kThreads * kVec)
    *reinterpret_cast<float4*>(g + i) = *reinterpret_cast<const float4*>(gsrc + i);
  place_window(fp, coords + static_cast<size_t>(e) * PP * 2, PP, H, W, tid);

  const float* fbase = fmap + static_cast<size_t>(jj[e]) * H * W * C;
  if (PP == 9)
    surface_pair<9>(surf, g, fbase, fp.wy0, fp.wx0, H, W, C, PP, tid);
  else
    surface_pair<kMaxPP>(surf, g, fbase, fp.wy0, fp.wx0, H, W, C, PP, tid);
  __syncthreads();
  direct_taps(taps, g, C, fbase, fp, PP, C, H, W, tid, kThreads);
  __syncthreads();
  fixed_row(out + static_cast<size_t>(e) * kOut * kOut * PP, surf, PP, taps,
            fp, outs, tid, kThreads);
}

// ---------------------------------------------------------------------------
// bf16 rings and patch features: the surface on the tensor cores.

constexpr int kMmaThreads = 256;
constexpr int kMmaWarps = kMmaThreads / 32;
constexpr int kWarpTiles = kPositions / 16 / kMmaWarps;    // m-tiles a warp
constexpr int kStages = 2;
constexpr int kStageElems = kPositions * kMmaChunk;        // bf16 of a stage

// Dynamic shared memory of a block: the stages of the window, the patch
// feature, the f32 surface and the direct taps (ops/corr_cuda.fixed_smem_bytes
// is the same sum).
inline size_t mma_smem(int PP, int C) {
  return (static_cast<size_t>(kStages) * kStageElems +
          static_cast<size_t>(PP) * mma_stride(C)) * sizeof(__nv_bfloat16) +
         (static_cast<size_t>(kPositions) * surface_stride(PP) + PP * kTapCount) *
             sizeof(float);
}

// CB: bytes of a copy, the largest of 16 and 8 that a feature vector is a
// whole number of
template <int CB>
__global__ void __launch_bounds__(kMmaThreads, 3)
corr_fixed_mma_kernel(const __nv_bfloat16* __restrict__ gmap,
                      const __nv_bfloat16* __restrict__ fmap,
                      const float* __restrict__ coords,
                      const int* __restrict__ kk, const int* __restrict__ jj,
                      float* __restrict__ out, int PP, int C, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int chans = mma_channels(C), gstride = mma_stride(C);
  const int ss = surface_stride(PP);
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* g = stages + kStages * kStageElems;       // (PP, gstride)
  float* surf = reinterpret_cast<float*>(g + PP * gstride); // (384, ss)
  float* taps = surf + kPositions * ss;                     // (PP, 8, 8)
  __shared__ FixedPrep fp;

  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int outs[kMaxOuts];
  decode_outputs(outs, PP, tid, kMmaThreads);
  place_window(fp, coords + static_cast<size_t>(e) * PP * 2, PP, H, W, tid);
  const int wy0 = fp.wy0, wx0 = fp.wx0;
  const int r0 = fp.r0, r1 = fp.r1, c0 = fp.c0, c1 = fp.c1;
  // the warp's m-tiles that hold a position of the rows the taps read
  bool live[kWarpTiles];
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j) {
    const int m0 = (warp + kMmaWarps * j) * 16;
    live[j] = m0 / kCols <= r1 && (m0 + 15) / kCols >= r0;
  }
  const __nv_bfloat16* gsrc = gmap + static_cast<size_t>(kk[e]) * PP * C;
  const __nv_bfloat16* fbase = fmap + static_cast<size_t>(jj[e]) * H * W * C;

  // channels k*32 .. k*32+31 of the positions p0 .. p1-1 (the m-tiles that
  // hold a covered row, the only ones multiplied) into stage k % kStages:
  // from the ring where the taps read them, zeros elsewhere
  const int p0 = r0 <= r1 ? r0 * kCols / 16 * 16 : 0;
  const int p1 = r0 <= r1 ? ((r1 + 1) * kCols + 15) / 16 * 16 : 0;
  auto stage_chunk = [&](int k) {
    const int ch = k * kMmaChunk;
    stage_rows<CB>(
        stages + (k % kStages) * kStageElems + p0 * kMmaChunk, kMmaChunk,
        p1 - p0, kMmaChunk, C - ch,
        [&](int i) -> const __nv_bfloat16* {
          const int pos = p0 + i;
          const int r = pos / kCols, c = pos - r * kCols;
          const int iy = wy0 + r, ix = wx0 + c;
          if (r < r0 || r > r1 || c < c0 || c > c1 || iy < 0 || iy >= H ||
              ix < 0 || ix >= W)
            return nullptr;
          return fbase + (static_cast<size_t>(iy) * W + ix) * C + ch;
        },
        fbase, tid, kMmaThreads);
  };
  // group 0: the patch feature and chunk 0; group k < kStages - 1: chunk k
  // (or nothing)
  const int n_chunks = chans / kMmaChunk;
  stage_rows<CB>(g, gstride, PP, chans, C,
                 [&](int p) { return gsrc + static_cast<size_t>(p) * C; }, gsrc,
                 tid, kMmaThreads);
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < n_chunks) stage_chunk(k);
    cp_async_commit();
  }

  float d[kWarpTiles][2][4] = {};
  for (int k = 0; k < n_chunks; ++k) {
    cp_async_wait<kStages - 2>();   // this thread's copies of chunk k
    __syncthreads();                // everyone's; and chunk k-1 is done with
    if (k + kStages - 1 < n_chunks) stage_chunk(k + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* win = stages + (k % kStages) * kStageElems;
    ChunkB b;
    b.load(g, gstride, PP, k * kMmaChunk, lane);
#pragma unroll
    for (int j = 0; j < kWarpTiles; ++j)
      if (live[j])
        tile_chunk(d[j], win, kMmaChunk, (warp + kMmaWarps * j) * 16, 0, b, lane);
  }
#pragma unroll
  for (int j = 0; j < kWarpTiles; ++j)
    if (live[j])
      store_tile(surf, ss, (warp + kMmaWarps * j) * 16, d[j], PP, 1.0f, lane);
  direct_taps(taps, g, gstride, fbase, fp, PP, C, H, W, tid, kMmaThreads);
  __syncthreads();
  fixed_row(out + static_cast<size_t>(e) * kOut * kOut * PP, surf, ss, taps,
            fp, outs, tid, kMmaThreads);
}

int launch_f32(const void* gmap, const void* fmap, const void* coords,
               const void* kk, const void* jj, void* out, int E, int PP, int C,
               int H, int W, cudaStream_t st) {
  const size_t smem =
      (static_cast<size_t>(PP) * C + (kPositions + kTapCount) * PP) * sizeof(float);
  const cudaError_t err = allow_shared_memory(corr_fixed_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_fixed_kernel<<<E, kThreads, smem, st>>>(
      static_cast<const float*>(gmap), static_cast<const float*>(fmap),
      static_cast<const float*>(coords), static_cast<const int*>(kk),
      static_cast<const int*>(jj), static_cast<float*>(out), PP, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

template <int CB>
int launch_mma(const void* gmap, const void* fmap, const void* coords,
               const void* kk, const void* jj, void* out, int E, int PP, int C,
               int H, int W, cudaStream_t st) {
  const size_t smem = mma_smem(PP, C);
  const cudaError_t err = allow_shared_memory(corr_fixed_mma_kernel<CB>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_fixed_mma_kernel<CB><<<E, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(gmap),
      static_cast<const __nv_bfloat16*>(fmap),
      static_cast<const float*>(coords), static_cast<const int*>(kk),
      static_cast<const int*>(jj), static_cast<float*>(out), PP, C, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C) and fmap (mem, H, W, C),
// both bf16 if bf16 else f32; coords (E, P, P, 2) f32 at this level's
// resolution; kk / jj (E,) int32 ring indices; out (E, 49*P*P) f32. C is a
// multiple of 4, P*P at most 16. The shared memory taken is that of
// ops/corr_cuda.fixed_smem_bytes (devo_corr_fixed_smem).
extern "C" int devo_corr_fixed(const void* gmap, const void* fmap,
                               const void* coords, const void* kk,
                               const void* jj, void* out, int E, int PP, int C,
                               int H, int W, int bf16, void* stream) {
  if (E == 0) return 0;
  if (PP > kMaxPP) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!bf16)
    return launch_f32(gmap, fmap, coords, kk, jj, out, E, PP, C, H, W, st);
  return copy_bytes(2 * C) == 16
             ? launch_mma<16>(gmap, fmap, coords, kk, jj, out, E, PP, C, H, W, st)
             : launch_mma<8>(gmap, fmap, coords, kk, jj, out, E, PP, C, H, W, st);
}

// The dynamic shared memory devo_corr_fixed takes at these sizes.
extern "C" long long devo_corr_fixed_smem(int PP, int C, int bf16) {
  if (bf16) return static_cast<long long>(mma_smem(PP, C));
  return static_cast<long long>(
      (static_cast<size_t>(PP) * C + (kPositions + kTapCount) * PP) * sizeof(float));
}

// Blocks of devo_corr_fixed's kernel that one SM of the current device holds
// at these sizes, or minus the cudaError_t of the query.
extern "C" int devo_corr_fixed_blocks_per_sm(int PP, int C, int bf16) {
  const size_t smem = static_cast<size_t>(devo_corr_fixed_smem(PP, C, bf16));
  int blocks = 0;
  cudaError_t err;
  if (!bf16) {
    err = allow_shared_memory(corr_fixed_kernel, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, corr_fixed_kernel, kThreads, smem);
  } else if (copy_bytes(2 * C) == 16) {
    err = allow_shared_memory(corr_fixed_mma_kernel<16>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, corr_fixed_mma_kernel<16>, kMmaThreads, smem);
  } else {
    err = allow_shared_memory(corr_fixed_mma_kernel<8>, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, corr_fixed_mma_kernel<8>, kMmaThreads, smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}
