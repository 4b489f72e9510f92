// Two-level sparse patch correlation for the DEVO tracking step, for Hopper
// (sm_90a): the engine's default kernel (CORR_KERNEL="mono"). Plain C
// interface, loaded with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_mono`
// (devo_tpu/ops/corr_pallas.py:1553, reached through corr_pyramid_banded
// :1962 -> corr_pyramid_pair2 :1835, pallas_call at :1944) together with its
// XLA glue: lookup_g (:968), _pair_level_index (:1195), the banded ring
// writes band_frame / band_frame_i8 (:242, :266) and ops/corr.blend_strips
// (devo_tpu/ops/corr.py:180). It computes the function, not the TPU
// schedule: plain (mem, h, w, C) rings, no banding, stagger or window clip.
//
// What it computes, per edge e:
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
// slot's dequantisation scale dq_l[jj[e]] multiplies each f32 tap.
//
// What bounds it on an H100: bytes. Per edge at P = 3, C = 128 the 3x3
// patch's 8x8 tap grids cover about 10x10 feature vectors a level (25.6 KB
// of bf16, 12.8 KB of int8 at level 1); the level-1 ring (32 x 120 x 160 x
// 128 bf16, 157 MB) does not fit the 50 MB L2. The products, 2 x 9 x 64 x C
// multiply-adds an edge, are far below the tensor cores' rate. What the
// design does about it:
//   - a block walks a run of consecutive edges (the wrapper spreads the edges
//     over one round of blocks, one an SM: ops/corr_cuda.mono_run) as two
//     independent pipelines: each half of the block (256 threads, its own
//     named barrier) takes every other edge of the run, so that one half's
//     waits and barriers overlap the other half's work. A half keeps
//     depth / 2 stages of the ring: the copies (cp.async, 16 bytes where the
//     vector allows) of its edge i + depth/2 -- the patch feature and both
//     levels' covering windows, the union of the pixels' 8x8 grids -- start
//     as soon as the products of its edge i are done, and fly during the
//     extraction of edge i and the products in between. Every feature
//     vector leaves device memory or L2 once per edge;
//   - bf16 patch features (bf16 or int8 rings): the window product runs on
//     the tensor cores (corr_mma.cuh): the window's positions, padded to a
//     multiple of 16, as A, the patch's pixels as B, both levels' m-tiles
//     spread over the half's warps, the int8 -> bf16 conversion in the
//     fragment loads. Windows are staged with zeros off the image, in the
//     K tail and in the padding rows;
//   - f32 patch features (MIXED_PRECISION=False) are never rounded: the
//     same staged window is dotted on the CUDA cores, one position a thread
//     against all pixels (position_products);
//   - the surface, (positions, pixels) f32 a level with the slot's scale
//     applied, goes to the half's slot of the level in shared memory; after
//     the half's barrier its threads read each output's four taps from it,
//     blend and write the edge's row (their output indices decoded once);
//   - a level whose covering window exceeds `cap` (a strongly distorted
//     patch), or, for f32 patch features, a ring whose vector is no multiple
//     of 16 bytes (cap = 0), takes its taps from the ring, one dot a tap, into
//     the same slot: nothing is clipped.
// No atomics, and every sum in a fixed order: two launches give the same
// bits.
//
// Hazards, for the reader of a half's loop: two half barriers an edge i,
// A(i) before the products and B(i) after them. The stage of edge i is
// written by copies started after B(i - depth/2), whose products read it
// before that barrier, and read by the products of i, behind A(i) (which
// follows each thread's wait for its own copies). The half's surface slots
// are written by the products of i, behind A(i), which every thread passes
// only after its extraction of i-1, and read by the extraction of i, behind
// B(i). The index table of edge i + depth/2 is written before B(i) by the
// half's last warp, into slot (i + depth/2) % kHalfPrep, whose edge was
// last read by an extraction behind A(i); it is read by the copies started
// after B(i), and by everything of that edge later.

#include <type_traits>

#include "corr_mma.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 512;
constexpr int kHalves = 2;                       // edge pipelines a block
constexpr int kHalfThreads = kThreads / kHalves;
constexpr int kHalfWarps = kHalfThreads / 32;
constexpr int kMaxDepth = 4;                     // stages, both halves'
constexpr int kHalfPrep = kMaxDepth / kHalves + 1;   // index tables a half
// outputs of an edge a thread writes, at most (2 levels x 49 x 16 pixels)
constexpr int kOutsPerThread =
    (2 * 7 * 7 * kMaxPP + kHalfThreads - 1) / kHalfThreads;

// The barrier of one half of the block (named barrier 1 + half).
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(half + 1), "n"(kHalfThreads)
               : "memory");
}

template <typename G>
constexpr bool kMma = std::is_same<G, __nv_bfloat16>::value;

// How a block lays out its shared memory: `depth` stages (depth / 2 for
// each half of the block), each the patch feature (PP rows of gstride
// elements of G) and both levels' windows (cap rows of wstride elements of
// F), then four surface slots (two halves x two levels) of `slot` floats.
// The wrapper's ops/corr_cuda.mono_smem_bytes is the same sum.
template <typename G, typename F>
struct MonoLayout {
  int chans;      // channels of a staged row (C, or C rounded up to chunks)
  int gstride, wstride;
  size_t gbytes, stage;
  int ss, slot;
  __host__ __device__ MonoLayout(int PP, int C, int cap) {
    chans = kMma<G> ? mma_channels(C) : C;
    gstride = kMma<G> ? mma_stride(C) : C;
    wstride = kMma<G> ? mma_stride(C) : padded_stride<F>(C);
    gbytes = (static_cast<size_t>(PP) * gstride * sizeof(G) + 15) / 16 * 16;
    stage = gbytes + 2 * static_cast<size_t>(cap) * wstride * sizeof(F);
    ss = surface_stride(PP);
    slot = cap * ss > PP * kTaps * kTaps ? cap * ss : PP * kTaps * kTaps;
  }
  __host__ __device__ size_t bytes(int depth) const {
    return depth * stage + 4 * static_cast<size_t>(slot) * sizeof(float);
  }
};

// Start the copies of a level's covering window into `win` (rows `stride`
// elements apart): positions 0 .. rows-1 of the ww-wide window at (wy0, wx0)
// in the ring slot fbase (H x W vectors of C elements), `chans` elements a
// row (a multiple of the copy); zeros past the window's n_pos positions, off
// the image and past C; by the threads tid = 0 .. kHalfThreads - 1 of a
// half. Where the copies of a row divide those, a thread keeps to one copy
// of a row and walks the positions kHalfThreads / (copies a row) apart,
// carrying their row and column along, so that the loop divides nothing.
// The caller commits the group.
template <int CB, typename F>
__device__ __forceinline__ void stage_window(F* win, int stride, int rows,
                                             int chans, int C, const F* fbase,
                                             int n_pos, int ww, int wy0,
                                             int wx0, int H, int W, int tid) {
  constexpr int kEl = CB / static_cast<int>(sizeof(F));
  const int per_row = chans / kEl;
  auto src = [&](int pos, int r, int x) -> const F* {
    const int iy = wy0 + r, ix = wx0 + x;
    if (pos >= n_pos || iy < 0 || iy >= H || ix < 0 || ix >= W) return nullptr;
    return fbase + (static_cast<size_t>(iy) * W + ix) * C;
  };
  if (kHalfThreads % per_row != 0) {
    stage_rows<CB>(win, stride, rows, chans, C,
                   [&](int pos) { return src(pos, pos / ww, pos % ww); },
                   fbase, tid, kHalfThreads);
    return;
  }
  const int c = (tid % per_row) * kEl;
  const int step = kHalfThreads / per_row;
  const int dr = step / ww, dx = step - dr * ww;
  int pos = tid / per_row;
  int r = pos / ww, x = pos - r * ww;
  for (; pos < rows; pos += step) {
    const F* s = c < C ? src(pos, r, x) : nullptr;
    cp_async_zfill<CB>(win + static_cast<size_t>(pos) * stride + c,
                       s ? s + c : fbase, s != nullptr);
    x += dx;
    r += dr;
    if (x >= ww) {
      x -= ww;
      ++r;
    }
  }
}

template <typename G, typename F>
struct MonoArgs {
  PairArgs<G, F> p;
  int depth;                // stages of the window ring, 2 or kMaxDepth
  int run;                  // consecutive edges a block walks
};

// G: type of the patch features, F: type of the rings (G or int8_t)
template <typename G, typename F>
__global__ void __launch_bounds__(kThreads, 1)
corr_pyramid_kernel(const MonoArgs<G, F> args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePrep prep[kHalves][kHalfPrep];
  __shared__ __align__(16) float ce_next[kHalves][2 * kMaxPP];
  const PairArgs<G, F>& a = args.p;
  const int PP = a.PP, C = a.C, cap = a.cap;
  const int depth = args.depth;
  const int hdepth = depth / kHalves;     // stages of a half
  const MonoLayout<G, F> lay(PP, C, cap);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int half = tid / kHalfThreads;
  const int htid = tid % kHalfThreads;
  const int hwarp = htid >> 5;
  const int n_out = 2 * kOut * kOut * PP;
  const int block_first = static_cast<int>(blockIdx.x) * args.run;
  const int first = block_first + half;   // the half's first edge
  // the half's edges: every other one of the block's run
  const int count = (min(args.run, a.E - block_first) - half + 1) / 2;
  // the half's surface slots, one a level
  float* slots = reinterpret_cast<float*>(smem_raw + depth * lay.stage) +
                 half * 2 * lay.slot;
  // this thread's outputs o = htid + k * kHalfThreads of every edge's row,
  // decoded once: o = ((ox * 7 + oy) * PP + p) * 2 + lvl, packed as
  // lvl | p << 1 | oy << 5 | ox << 8 (-1 past the row)
  int outs[kOutsPerThread];
#pragma unroll
  for (int k = 0; k < kOutsPerThread; ++k) {
    const int o = htid + k * kHalfThreads;
    const int q = o >> 1, p = q % PP, t = q / PP;
    outs[k] = o < n_out ? (o & 1) | p << 1 | (t % kOut) << 5 | (t / kOut) << 8
                        : -1;
  }

  // the half's i-th edge (edge first + 2i of the run) has stage
  // half + 2 * (i % hdepth) and index table prep[half][i % kHalfPrep]
  auto stage_of = [&](int i) {
    return smem_raw + (half + kHalves * (i % hdepth)) * lay.stage;
  };
  auto gstage = [&](int i) { return reinterpret_cast<G*>(stage_of(i)); };
  auto window = [&](int i, int lvl) {
    return reinterpret_cast<F*>(stage_of(i) + lay.gbytes) +
           static_cast<size_t>(lvl) * cap * lay.wstride;
  };
  auto edge = [&](int i) { return static_cast<size_t>(first) + 2 * i; };
  // the levels' ring sizes, held apart so that no array of the arguments is
  // indexed at run time (that would copy the arguments to local memory)
  const int H0 = a.H[0], W0 = a.W[0], H1 = a.H[1], W1 = a.W[1];
  const F* const fmap0 = a.fmap[0];
  const F* const fmap1 = a.fmap[1];
  // the arguments without the scales, for the index tables of the edges
  // ahead, whose scales were loaded before the products
  PairArgs<G, F> unscaled = a;
  unscaled.dq[0] = unscaled.dq[1] = nullptr;
  auto ring_slot = [&](const EdgePrep& ep, int lvl) {
    const size_t frame_size = lvl ? static_cast<size_t>(H1) * W1 * C
                                  : static_cast<size_t>(H0) * W0 * C;
    return (lvl ? fmap1 : fmap0) + ep.frame * frame_size;
  };
  // rows of a level's staged window: its positions, padded to whole m-tiles
  // for the tensor cores; 0 where the level reads the ring
  auto rows_of = [&](const EdgePrep& ep, int lvl) {
    const int n = ep.ww[lvl] * ep.wh[lvl];
    return kMma<G> ? (n + 15) / 16 * 16 : n;
  };
  // the copies of the half's i-th edge into its stage, by the half's threads
  auto start_copies = [&](int i) {
    const EdgePrep& ep = prep[half][i % kHalfPrep];
    const G* gsrc = a.gmap + static_cast<size_t>(ep.kk) * PP * C;
    stage_rows_any(gstage(i), lay.gstride, PP, lay.chans, C,
                   [&](int p) { return gsrc + static_cast<size_t>(p) * C; },
                   gsrc, htid, kHalfThreads);
    for (int lvl = 0; lvl < 2; ++lvl) {
      const int ww = ep.ww[lvl];
      if (ww == 0) continue;
      const int n_pos = ww * ep.wh[lvl];
      const int H = lvl ? H1 : H0, W = lvl ? W1 : W0;
      const int wx0 = ep.wx0[lvl], wy0 = ep.wy0[lvl];
      const F* fbase = ring_slot(ep, lvl);
      F* win = window(i, lvl);
      const int rows = rows_of(ep, lvl);
      switch (copy_bytes(C * static_cast<int>(sizeof(F)))) {
#define DEVO_STAGE(CB)                                                     \
  stage_window<CB>(win, lay.wstride, rows, lay.chans, C, fbase, n_pos, ww, \
                   wy0, wx0, H, W, htid)
        case 16: DEVO_STAGE(16); break;
        case 8: DEVO_STAGE(8); break;
        default: DEVO_STAGE(4); break;
#undef DEVO_STAGE
      }
    }
  };

  // the index tables of the half's first hdepth edges, a warp each, and
  // their copies, a group each
  for (int i = hwarp; i < hdepth && i < count; i += kHalfWarps) {
    const size_t e = edge(i);
    prep_edge(prep[half][i], a, a.coords + e * PP * 2, a.kk[e], a.jj[e], lane);
  }
  half_sync(half);
  for (int i = 0; i < hdepth; ++i) {
    if (i < count) start_copies(i);
    cp_async_commit();
  }

  for (int i = 0; i < count; ++i) {
    const EdgePrep& ep = prep[half][i % kHalfPrep];
    // (the half's last warp) edge i+hdepth's coordinates, indices and
    // scales, loaded now and written as its index table after the products
    const bool prep_ahead = hwarp == kHalfWarps - 1 && i + hdepth < count;
    float2 c_next = make_float2(0.0f, 0.0f);
    int kk_next = 0, jj_next = 0;
    float q_next = 1.0f;          // lane l < 2: level l's scale
    if (prep_ahead) {
      const size_t en = edge(i + hdepth);
      if (lane < PP)
        c_next = *reinterpret_cast<const float2*>(a.coords + (en * PP + lane) * 2);
      kk_next = a.kk[en];
      jj_next = a.jj[en];
      const float* dq = lane ? a.dq[1] : a.dq[0];
      if (lane < 2 && dq) q_next = dq[jj_next];
    }
    cp_async_wait_pending(hdepth - 1);  // this thread's copies of edge i
    half_sync(half);                    // A(i): everyone's; slots free

    // the surface of each level into the half's slot of the level
    const G* g = gstage(i);
    const int rows0 = rows_of(ep, 0), rows1 = rows_of(ep, 1);
    if constexpr (kMma<G>) {
      // the m-tiles of both levels, one warp each in turn
      const int tiles0 = rows0 / 16, tiles = tiles0 + rows1 / 16;
      for (int tile = hwarp; tile < tiles; tile += kHalfWarps) {
        const int lvl = tile >= tiles0;
        const int m0 = (tile - lvl * tiles0) * 16;
        const F* win = window(i, lvl);
        float d[2][4] = {};
        for (int c0 = 0; c0 < lay.chans; c0 += kMmaChunk) {
          ChunkB b;
          b.load(g, lay.gstride, PP, c0, lane);
          tile_chunk(d, win, lay.wstride, m0, c0, b, lane);
        }
        store_tile(slots + lvl * lay.slot, lay.ss, m0, d, PP, ep.q[lvl], lane);
      }
    } else {
      // one window position a thread, against every pixel
      for (int t = htid; t < rows0 + rows1; t += kHalfThreads) {
        const int lvl = t >= rows0;
        const int pos = t - lvl * rows0;
        const F* vec = window(i, lvl) + static_cast<size_t>(pos) * lay.wstride;
        float* dst = slots + lvl * lay.slot + pos * lay.ss;
        if (PP == 9) {
          float acc[9];
          position_products<9>(g, vec, C, acc);
#pragma unroll
          for (int p = 0; p < 9; ++p) dst[p] = acc[p] * ep.q[lvl];
        } else {
          position_products_any(g, vec, C, PP, dst, 1);
          for (int p = 0; p < PP; ++p) dst[p] *= ep.q[lvl];
        }
      }
    }
    // a level without a staged window: its taps from the ring, (PP, 8, 8)
    for (int lvl = 0; lvl < 2; ++lvl) {
      if (ep.ww[lvl] > 0) continue;
      const int H = lvl ? H1 : H0, W = lvl ? W1 : W0;
      const F* fbase = ring_slot(ep, lvl);
      for (int it = htid; it < PP * kTaps * kTaps; it += kHalfThreads) {
        const int p = it / (kTaps * kTaps);
        const int tap = it - p * kTaps * kTaps;
        const int iy = ep.y0[lvl][p] + tap / kTaps - kRadius;
        const int ix = ep.x0[lvl][p] + tap % kTaps - kRadius;
        slots[lvl * lay.slot + it] =
            (iy < 0 || iy >= H || ix < 0 || ix >= W)
                ? 0.0f
                : dot_any(g + static_cast<size_t>(p) * lay.gstride,
                          fbase + (static_cast<size_t>(iy) * W + ix) * C, C) *
                      ep.q[lvl];
      }
    }

    if (prep_ahead) {
      float* ce = ce_next[half];
      if (lane < PP) {
        ce[2 * lane] = c_next.x;
        ce[2 * lane + 1] = c_next.y;
      }
      __syncwarp();
      EdgePrep& next = prep[half][(i + hdepth) % kHalfPrep];
      prep_edge(next, unscaled, ce, kk_next, jj_next, lane);
      if (lane < 2) next.q[lane] = q_next;
      __syncwarp();
    }
    half_sync(half);                    // B(i): the surface is complete

    // the stage of edge i is read no more: the copies of edge i+hdepth
    if (i + hdepth < count) start_copies(i + hdepth);
    cp_async_commit();              // a group every iteration, empty at the end

    // extraction and blend, from the surface or the taps
    float* dst = a.out + edge(i) * n_out;
#pragma unroll
    for (int k = 0; k < kOutsPerThread; ++k) {
      if (outs[k] < 0) continue;
      const int o = htid + k * kHalfThreads;
      const int lvl = outs[k] & 1, p = outs[k] >> 1 & 15;
      const int oy = outs[k] >> 5 & 7, ox = outs[k] >> 8;
      const float fx = ep.fx[lvl][p], fy = ep.fy[lvl][p];
      const float* slot = slots + lvl * lay.slot;
      const int ww = ep.ww[lvl];
      if (ww > 0) {
        const int r = ep.y0[lvl][p] + oy - kRadius - ep.wy0[lvl];
        const int c = ep.x0[lvl][p] + ox - kRadius - ep.wx0[lvl];
        dst[o] = blend_at(slot + (r * ww + c) * lay.ss + p, lay.ss,
                          ww * lay.ss, fx, fy);
      } else {
        dst[o] = blend_frac(slot + p * kTaps * kTaps, ox, oy, fx, fy);
      }
    }
  }
}

template <typename G, typename F>
int launch(const MonoArgs<G, F>& args, cudaStream_t st) {
  const PairArgs<G, F>& a = args.p;
  const size_t smem = MonoLayout<G, F>(a.PP, a.C, a.cap).bytes(args.depth);
  const cudaError_t err = allow_shared_memory(corr_pyramid_kernel<G, F>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.E + args.run - 1) / args.run;
  corr_pyramid_kernel<G, F><<<grid, kThreads, smem, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename G, typename F>
int blocks_per_sm(int PP, int C, int cap, int depth) {
  const size_t smem = MonoLayout<G, F>(PP, C, cap).bytes(depth);
  cudaError_t err = allow_shared_memory(corr_pyramid_kernel<G, F>, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, corr_pyramid_kernel<G, F>, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

#define DEVO_TYPES(CALL)                                                  \
  (g_bf16 ? (ring_i8 ? CALL(__nv_bfloat16, int8_t)                        \
                     : CALL(__nv_bfloat16, __nv_bfloat16))                \
          : (ring_i8 ? CALL(float, int8_t) : CALL(float, float)))

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C), bf16 if g_bf16 else f32;
// fmap1 (mem, h1, w1, C) and fmap2 (mem, h2, w2, C), of gmap's type, or
// int8 if ring_i8, and then dq1, dq2 (mem,) f32 are the slots' scales (null
// otherwise); coords (E, P, P, 2) f32 at level-1 resolution, divided by
// lvl1 and lvl2 in the kernel; kk / jj (E,) int32 ring indices; out
// (E, 2*49*P*P) f32. C is a multiple of 4, P*P at most 16. `cap`: feature
// vectors of a staged window (a multiple of 16 for bf16 patch features; 0 =
// every tap reads the ring), `depth`: stages of the window ring (2 or 4,
// half of them each half's), `run`: consecutive edges a block walks (at
// least 1). The
// dynamic shared memory taken is devo_corr_pyramid_smem's, that of
// ops/corr_cuda.mono_smem_bytes.
extern "C" int devo_corr_pyramid(const void* gmap, const void* fmap1,
                                 const void* fmap2, const void* dq1,
                                 const void* dq2, const void* coords,
                                 const void* kk, const void* jj, void* out,
                                 int E, int PP, int C, int h1, int w1, int h2,
                                 int w2, int cap, float lvl1, float lvl2,
                                 int g_bf16, int ring_i8, int depth, int run,
                                 void* stream) {
  if (E == 0) return 0;
  if (PP > kMaxPP || depth < kHalves || depth > kMaxDepth ||
      depth % kHalves != 0 || run < 1 || (g_bf16 && cap % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(G, F)                                                     \
  launch(MonoArgs<G, F>{pair_args<G, F>(gmap, fmap1, fmap2, dq1, dq2, coords, \
                                        kk, jj, out, E, PP, C, h1, w1, h2,    \
                                        w2, cap, lvl1, lvl2),                 \
                        depth, run},                                          \
         st)
  return DEVO_TYPES(DEVO_LAUNCH);
#undef DEVO_LAUNCH
}

// The dynamic shared memory devo_corr_pyramid takes at these sizes.
extern "C" long long devo_corr_pyramid_smem(int PP, int C, int cap, int depth,
                                            int g_bf16, int ring_i8) {
#define DEVO_SMEM(G, F) \
  static_cast<long long>(MonoLayout<G, F>(PP, C, cap).bytes(depth))
  return DEVO_TYPES(DEVO_SMEM);
#undef DEVO_SMEM
}

// Blocks of devo_corr_pyramid's kernel that one SM of the current device
// holds at these sizes, or minus the cudaError_t of the query.
extern "C" int devo_corr_pyramid_blocks_per_sm(int PP, int C, int cap,
                                               int depth, int g_bf16,
                                               int ring_i8) {
#define DEVO_OCC(G, F) blocks_per_sm<G, F>(PP, C, cap, depth)
  return DEVO_TYPES(DEVO_OCC);
#undef DEVO_OCC
}

#undef DEVO_TYPES

extern "C" const char* devo_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
