// One pyramid level of the sparse patch correlation as a raw product surface,
// eight edges a block, for Hopper (sm_90a): stage 1 of CORR_KERNEL="g8c".
// Plain C interface, loaded with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_g8c`
// (devo_tpu/ops/corr_pallas.py:614, reached through corr_level_banded :738
// with ablate="g8c", pallas_call at :886) together with its XLA glue: lookup_g
// (:968) and the index preamble (:784-810). What that kernel is: groups of
// eight edges share one product, eight windows side by side against the block
// diagonal of their patch features, and the kernel writes the raw product
// surface, bf16, lane 16*j + p = edge j of the group, pixel p, and extracts
// nothing: extraction, the int8 scale, the blend and the mask run afterwards
// over all edges at once, outside the kernel (there extract_blend_g8 :688,
// here ops/corr.extract_blend_group, plain tensor code on either device).
// The block diagonal is how a 128-lane matrix unit is filled; here each edge
// of a group takes its own products into its own 16 lanes and no cross
// product is formed. None of the TPU's shapes is kept: plain (mem, h, w, C)
// rings, no bands, stagger or 24-wide windows; a window is the union of the
// nine pixels' 8x8 tap grids, row-major, and out-of-image positions are zero.
//
// What it computes, per group b (one block) and edge j < 8 of it, e = 8b + j,
// with coords already at this level's resolution:
//   window  origin (wx0, wy0) = (min x0 - 3, min y0 - 3) over the pixels'
//           floors (x0, y0), extent ww x wh = (max - min + 8) each way
//   surface[b][r * ww + c][16 j + p] = bf16(<gmap[kk[e]][p],
//           fmap[jj[e], wy0 + r, wx0 + c]>), f32 sums rounded to nearest even,
//           0 off the image; an int8 ring enters as its integer values (the
//           slot's scale is stage 2's)
//   a window of more than `cap` positions (a strongly distorted patch; every
//   window where cap = 0, a ring whose vectors are no multiple of 16 bytes)
//   is not staged and the edge's rows hold its taps instead, so that no tap
//   is lost and none is clipped: surface[b][di * 8 + dj][16 j + p] =
//   bf16(<gmap[kk[e]][p], fmap[jj[e], y0[p] + di - 3, x0[p] + dj - 3]>).
//   Stage 2 knows the same rule and reads rows accordingly.
//   Lanes 16 j + P*P .. 16 j + 15 are zero; rows beyond an edge's window and
//   the lanes of edges beyond E stay unwritten, and stage 2 reads neither.
// ops/corr.group_surface is the plain version.
//
// What bounds it on an H100: by the roofline bytes: the surface, 32 bytes a
// window position, about 3.5 KB an edge a level, is written here and read
// again by stage 2, on top of the windows themselves. The products are plain
// f32 multiply-adds (no tensor cores in this version: a window (S, C) times a
// patch (C, 16) is a row of mma.sync.m16n8k16 tiles, left for a later
// change). What the design does:
//   - one thread takes one window position and dots its vector with all nine
//     pixels (position_products): the vector leaves shared memory once for
//     nine dots, and the thread has its 16 lanes of one surface row, 32
//     bytes, which it writes as two 16-byte stores: whole sectors. The patch
//     feature is read by all lanes at one address, which costs no bank
//     conflict but still fills every lane's registers, 1152 clocks a warp at
//     C = 128 (csrc/corr_mono3.cu says more): that, not the bytes, is what
//     the kernel's time is made of;
//   - a block of 288 threads takes two edges a step, 144 positions each, four
//     steps a group, with two parities of shared memory: the cp.async copies
//     of the next step's two windows, and the loads of its patch features
//     into registers, start before the products of this step;
//   - warps 0-7 work out one edge's floors and window each (EdgePrep) at the
//     start.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kHalf = 144;             // threads an edge
constexpr int kThreads = 2 * kHalf;
constexpr int kGroup = 8;              // edges a block
constexpr int kLanes = 16;             // surface lanes an edge
constexpr int kHold = 2;               // Held4 registers a thread

// one edge's 16 lanes of a surface row: bf16(acc[p]) for p < n, then zeros
__device__ __forceinline__ void store_lanes(__nv_bfloat16* dst, const float* acc,
                                            int n) {
  unsigned w[kLanes / 2];
#pragma unroll
  for (int i = 0; i < kLanes / 2; ++i) {
    const unsigned lo =
        2 * i < n ? __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i])) : 0u;
    const unsigned hi =
        2 * i + 1 < n ? __bfloat16_as_ushort(__float2bfloat16_rn(acc[2 * i + 1]))
                      : 0u;
    w[i] = lo | (hi << 16);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

template <typename G, typename F>
__global__ void __launch_bounds__(kThreads)
corr_group_kernel(const PairArgs<G, F> a, __nv_bfloat16* __restrict__ surface,
                  int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePrep prep[kGroup];
  const int PP = a.PP, C = a.C, H = a.H[0], W = a.W[0], cap = a.cap;
  const int stride = padded_stride<F>(C);
  float* gf = reinterpret_cast<float*>(smem_raw);     // (2, 2, PP, C) f32
  F* wins = reinterpret_cast<F*>(gf + 4 * PP * C);    // (2, 2, cap, stride)
  const size_t win_elems = static_cast<size_t>(cap) * stride;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int half = tid >= kHalf;
  const int t = tid - half * kHalf;
  const int start = (kVec * lane) % C;
  const int e0 = kGroup * blockIdx.x;
  const int n_e = min(kGroup, a.E - e0);
  const int steps = (n_e + 1) / 2;

  if (warp < n_e) {
    const size_t e = e0 + warp;
    prep_edge<1>(prep[warp], a, a.coords + e * PP * 2, a.kk[e], a.jj[e], lane);
  }
  __syncthreads();

  auto window = [&](int s) { return wins + ((s & 1) * 2 + half) * win_elems; };
  auto patch = [&](int s) { return gf + ((s & 1) * 2 + half) * PP * C; };
  auto gsrc = [&](int k) {
    return a.gmap + static_cast<size_t>(prep[k].kk) * PP * C;
  };
  // this half's copies of its edge of step s
  auto start_copies = [&](int s) {
    const int k = 2 * s + half;
    if (k < n_e)
      stage_window(window(s), a.fmap[0] + static_cast<size_t>(prep[k].frame) * H * W * C,
                   prep[k], 0, H, W, C, t, kHalf, stride);
  };

  if (half < n_e)
    for (int i = t * kVec; i < PP * C; i += kHalf * kVec) {
      Held4<G> h;
      h.load(gsrc(half) + i);
      h.store(patch(0) + i);
    }
  start_copies(0);
  cp_async_commit();

  for (int s = 0; s < steps; ++s) {
    const int k = 2 * s + half;              // this half's edge of the group
    const int k_next = k + 2;
    if (s + 1 < steps) start_copies(s + 1);
    cp_async_commit();              // a group every step, empty at the end
    Held4<G> held[kHold];
    if (k_next < n_e) {
#pragma unroll
      for (int h = 0; h < kHold; ++h) {
        const int i = (t + h * kHalf) * kVec;
        if (i < PP * C) held[h].load(gsrc(k_next) + i);
      }
    }
    cp_async_wait<1>();             // this thread's copies of step s landed
    __syncthreads();                // A(s): everyone's did, and the patch
                                    //   features of step s are written

    if (k < n_e) {
      const EdgePrep& ep = prep[k];
      const float* g = patch(s);
      __nv_bfloat16* out =
          surface + static_cast<size_t>(blockIdx.x) * rows * (kGroup * kLanes) +
          k * kLanes;
      const int ww = ep.ww[0];
      if (ww > 0) {
        const F* win = window(s);
        const int n_pos = ww * ep.wh[0];
        for (int pos = t; pos < n_pos; pos += kHalf) {
          const int r = pos / ww;
          const int iy = ep.wy0[0] + r;
          const int ix = ep.wx0[0] + pos - r * ww;
          __nv_bfloat16* dst = out + static_cast<size_t>(pos) * (kGroup * kLanes);
          if (iy < 0 || iy >= H || ix < 0 || ix >= W) {
            store_lanes(dst, nullptr, 0);
          } else if (PP == 9) {
            float acc[9];
            position_products<9>(g, win + static_cast<size_t>(pos) * stride, C,
                                 acc);
            store_lanes(dst, acc, 9);
          } else {
            float acc[kMaxPP];
            position_products_any(g, win + static_cast<size_t>(pos) * stride, C,
                                  PP, acc, 1);
            store_lanes(dst, acc, PP);
          }
        }
      } else {
        // not staged: the edge's rows hold its 8x8 taps, read from the ring
        const F* fbase = a.fmap[0] + static_cast<size_t>(ep.frame) * H * W * C;
        for (int tap = t; tap < kTaps * kTaps; tap += kHalf) {
          float acc[kMaxPP];
          for (int p = 0; p < PP; ++p) {
            const int iy = ep.y0[0][p] + tap / kTaps - kRadius;
            const int ix = ep.x0[0][p] + tap % kTaps - kRadius;
            acc[p] = (iy < 0 || iy >= H || ix < 0 || ix >= W)
                         ? 0.0f
                         : dot_rotated(g + p * C,
                                       fbase + (static_cast<size_t>(iy) * W + ix) * C,
                                       C, start);
          }
          store_lanes(out + static_cast<size_t>(tap) * (kGroup * kLanes), acc, PP);
        }
      }
    }

    if (k_next < n_e) {
      float* gn = patch(s + 1);
#pragma unroll
      for (int h = 0; h < kHold; ++h) {
        const int i = (t + h * kHalf) * kVec;
        if (i < PP * C) held[h].store(gn + i);
      }
      for (int i = (t + kHold * kHalf) * kVec; i < PP * C; i += kHalf * kVec) {
        Held4<G> h;
        h.load(gsrc(k_next) + i);
        h.store(gn + i);
      }
    }
    __syncthreads();                // B(s): this parity's windows and patch
                                    //   features are free for step s+2
  }
}

template <typename G, typename F>
int launch(const PairArgs<G, F>& a, void* surface, int rows, cudaStream_t st) {
  const size_t smem =
      4 * static_cast<size_t>(a.PP) * a.C * sizeof(float) +
      4 * static_cast<size_t>(a.cap) * padded_stride<F>(a.C) * sizeof(F);
  const cudaError_t err = allow_shared_memory(corr_group_kernel<G, F>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_group_kernel<G, F><<<(a.E + kGroup - 1) / kGroup, kThreads, smem, st>>>(
      a, static_cast<__nv_bfloat16*>(surface), rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. gmap, fmap, coords, kk, jj, E, PP, C, H, W and the
// type flags are those of devo_corr_level (csrc/corr_level.cu); dq is not
// read. surface: (ceil(E / 8), rows, 128) bf16, 32-byte aligned; rows is at
// least the larger of cap and 64. `cap` is the number of feature vectors of a
// staged window (0 = no window is staged); a vector must then be a multiple
// of 16 bytes. P*P is at most 16. The dynamic shared memory taken is that of
// ops/corr_cuda.group_smem_bytes.
extern "C" int devo_corr_group(const void* gmap, const void* fmap,
                               const void* coords, const void* kk,
                               const void* jj, void* surface, int E, int PP,
                               int C, int H, int W, int cap, int rows,
                               int g_bf16, int ring_i8, void* stream) {
  if (E == 0) return 0;
  if (rows < cap || rows < kTaps * kTaps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(G, F)                                                     \
  launch(level_args<G, F>(gmap, fmap, nullptr, coords, kk, jj, nullptr, E,    \
                          PP, C, H, W, cap),                                  \
         surface, rows, st)
  if (g_bf16)
    return ring_i8 ? DEVO_LAUNCH(__nv_bfloat16, int8_t)
                   : DEVO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  return ring_i8 ? DEVO_LAUNCH(float, int8_t) : DEVO_LAUNCH(float, float);
#undef DEVO_LAUNCH
}
