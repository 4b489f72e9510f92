// One pyramid level of the sparse patch correlation, eight edges a block, the
// product surface kept in the block, for Hopper (sm_90a): CORR_KERNEL="g8".
// Plain C interface, loaded with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_g8` (devo_tpu/ops/corr_pallas.py:549,
// reached through corr_level_banded :738 with ablate="g8", pallas_call at
// :928) together with its XLA glue: lookup_g (:968), the index preamble
// (:784-810) and ops/corr.blend_strips. What that kernel is: groups of eight
// edges share one product, eight windows side by side against the block
// diagonal of their patch features, an f32 surface in VMEM, and the kernel
// extracts every edge's tap strips from it before the group's block is done.
// This kernel keeps the group of eight consecutive edges, the f32 surface that
// never leaves the block and the extraction in the same block; it does not
// form the block diagonal's cross products (each edge's products go to its own
// slot), and it keeps none of the TPU's shapes: plain (mem, h, w, C) rings, no
// bands, stagger or 24-wide windows; a window is the union of the pixels' 8x8
// tap grids, and out-of-image positions are zero. Unlike csrc/corr_group.cu
// (K8', "g8c") nothing is rounded to bf16 and there is no second stage: the
// blend runs here too.
//
// What it computes, per group b (one block) of edges e = 8b + j, j < 8, with
// coords already at this level's resolution: ops/corr.corr_level, unclipped.
//   window  origin (wx0, wy0) = (min x0 - 3, min y0 - 3) over the pixels'
//           floors, extent ww x wh = (max - min + 8) each way
//   surface slot j, f32 in shared memory: s[r * ww + c][p] = <gmap[kk[e]][p],
//           fmap[jj[e], wy0 + r, wx0 + c]>, 0 off the image
//   a window of more than `cap` positions (a strongly distorted patch; every
//   window where cap = 0, a ring whose vectors are no multiple of 16 bytes)
//   is not staged and the slot holds the edge's taps instead, read from the
//   ring: s[di * 8 + dj][p] = <gmap[kk[e]][p], fmap[jj[e], y0[p] + di - 3,
//   x0[p] + dj - 3]> (csrc/corr_group.cu's rule), so that nothing is clipped
//   out     each pixel's 8x8 taps from its slot, blended to 7x7,
//           (E, 49*P*P) f32 in [dx, dy, pixel] order.
// A table whose length is no multiple of 8 leaves a last group of fewer
// edges; the block takes those alone.
//
// What bounds it on an H100: not the bytes (those of csrc/corr_level.cu) but,
// as in csrc/corr_group.cu, the plain f32 multiply-adds and the shared-memory
// traffic that feeds every thread the patch feature, and one block an SM:
// eight surfaces (41 KB), four windows and four patch features leave room for
// no second block. What the design does:
//   - K8''s pipeline: a block of 288 threads takes two edges a step, 144
//     window positions each, four steps a group, with two parities of shared
//     memory: the cp.async copies of the next step's two windows, and the
//     loads of its patch features into registers, start before the products
//     of this step;
//   - a thread dots one window position with all nine pixels
//     (position_products) into the edge's slot; the slots of all eight edges
//     stay in shared memory;
//   - after the last step one barrier, and the block extracts, blends and
//     writes the group's eight rows, 3528 outputs over 288 threads.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kHalf = 144;             // threads an edge
constexpr int kThreads = 2 * kHalf;
constexpr int kGroup = 8;              // edges a block
constexpr int kHold = 2;               // Held4 registers a thread
constexpr int kTapCount = kTaps * kTaps;

// positions of a surface slot: the staged window, or the 64 taps
__host__ __device__ inline int slot_positions(int cap) {
  return cap > kTapCount ? cap : kTapCount;
}

template <typename F>
__global__ void __launch_bounds__(kThreads)
corr_group8_kernel(const PairArgs<F, F> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePrep prep[kGroup];
  const int PP = a.PP, C = a.C, H = a.H[0], W = a.W[0], cap = a.cap;
  const int stride = padded_stride<F>(C);
  const int slot = slot_positions(cap) * PP;
  float* gf = reinterpret_cast<float*>(smem_raw);     // (2, 2, PP, C) f32
  float* surf = gf + 4 * PP * C;                      // (8, slot) f32
  F* wins = reinterpret_cast<F*>(surf + kGroup * slot);  // (2, 2, cap, stride)
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
  auto ring_slot = [&](int k) {
    return a.fmap[0] + static_cast<size_t>(prep[k].frame) * H * W * C;
  };
  // this half's copies of its edge of step s
  auto start_copies = [&](int s) {
    const int k = 2 * s + half;
    if (k < n_e) stage_window(window(s), ring_slot(k), prep[k], 0, H, W, C, t,
                              kHalf, stride);
  };

  if (half < n_e)
    for (int i = t * kVec; i < PP * C; i += kHalf * kVec) {
      Held4<F> h;
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
    Held4<F> held[kHold];
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
      float* out = surf + k * slot;
      const int ww = ep.ww[0];
      if (ww > 0) {
        const F* win = window(s);
        const int n_pos = ww * ep.wh[0];
        for (int pos = t; pos < n_pos; pos += kHalf) {
          const int r = pos / ww;
          const int iy = ep.wy0[0] + r;
          const int ix = ep.wx0[0] + pos - r * ww;
          float* dst = out + pos * PP;
          if (iy < 0 || iy >= H || ix < 0 || ix >= W) {
            for (int p = 0; p < PP; ++p) dst[p] = 0.0f;
          } else if (PP == 9) {
            float acc[9];
            position_products<9>(g, win + static_cast<size_t>(pos) * stride, C,
                                 acc);
#pragma unroll
            for (int p = 0; p < 9; ++p) dst[p] = acc[p];
          } else {
            position_products_any(g, win + static_cast<size_t>(pos) * stride, C,
                                  PP, dst, 1);
          }
        }
      } else {
        // not staged: the slot holds the edge's 8x8 taps, read from the ring
        const F* fbase = ring_slot(k);
        for (int it = t; it < kTapCount * PP; it += kHalf) {
          const int tap = it / PP;
          const int p = it - tap * PP;
          const int iy = ep.y0[0][p] + tap / kTaps - kRadius;
          const int ix = ep.x0[0][p] + tap % kTaps - kRadius;
          out[it] = (iy < 0 || iy >= H || ix < 0 || ix >= W)
                        ? 0.0f
                        : dot_rotated(g + p * C,
                                      fbase + (static_cast<size_t>(iy) * W + ix) * C,
                                      C, start);
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
        Held4<F> h;
        h.load(gsrc(k_next) + i);
        h.store(gn + i);
      }
    }
    __syncthreads();                // B(s): this parity's windows and patch
                                    //   features are free for step s+2, and
                                    //   after the last step every slot is
                                    //   written
  }

  // extraction and blend of the group's rows: out[e][(ox * 7 + oy) * PP + p]
  const int n_row = kOut * kOut * PP;
  for (int o = tid; o < n_e * n_row; o += kThreads) {
    const int k = o / n_row;
    const int i = o - k * n_row;
    const int p = i % PP;
    const int q = i / PP;
    const int ox = q / kOut, oy = q - ox * kOut;
    const EdgePrep& ep = prep[k];
    const int ww = ep.ww[0];
    // the four taps' surface rows: window positions, or tap indices
    const int r0 = ww > 0 ? (ep.y0[0][p] + oy - kRadius - ep.wy0[0]) * ww +
                                (ep.x0[0][p] + ox - kRadius - ep.wx0[0])
                          : oy * kTaps + ox;
    const int dy = ww > 0 ? ww : kTaps;
    const float* s = surf + k * slot + r0 * PP + p;
    const float fx = ep.fx[0][p], fy = ep.fy[0][p];
    a.out[static_cast<size_t>(e0 + k) * n_row + i] =
        (1.0f - fx) * (1.0f - fy) * s[0] + fx * (1.0f - fy) * s[PP] +
        (1.0f - fx) * fy * s[dy * PP] + fx * fy * s[(dy + 1) * PP];
  }
}

template <typename F>
int launch(const PairArgs<F, F>& a, cudaStream_t st) {
  const size_t smem =
      (4 * static_cast<size_t>(a.PP) * a.C +
       static_cast<size_t>(kGroup) * slot_positions(a.cap) * a.PP) * sizeof(float) +
      4 * static_cast<size_t>(a.cap) * padded_stride<F>(a.C) * sizeof(F);
  const cudaError_t err = allow_shared_memory(corr_group8_kernel<F>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_group8_kernel<F><<<(a.E + kGroup - 1) / kGroup, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C) and fmap (mem, H, W, C), both
// bf16 if bf16 else f32; coords (E, P, P, 2) f32 at this level's resolution;
// kk / jj (E,) int32 ring indices; out (E, 49*P*P) f32. C is a multiple of 4,
// P*P at most 16. `cap` is the number of feature vectors of a staged window
// (0 = no window is staged); a vector must then be a multiple of 16 bytes.
// The dynamic shared memory taken is that of
// ops/corr_cuda.group8_smem_bytes.
extern "C" int devo_corr_group8(const void* gmap, const void* fmap,
                                const void* coords, const void* kk,
                                const void* jj, void* out, int E, int PP, int C,
                                int H, int W, int cap, int bf16, void* stream) {
  if (E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(F)                                                        \
  launch(level_args<F, F>(gmap, fmap, nullptr, coords, kk, jj, out, E, PP, C, \
                          H, W, cap),                                         \
         st)
  return bf16 ? DEVO_LAUNCH(__nv_bfloat16) : DEVO_LAUNCH(float);
#undef DEVO_LAUNCH
}
