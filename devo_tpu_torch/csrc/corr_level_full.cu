// One pyramid level of the sparse patch correlation, a block walking a run of
// edges behind a ring of window copies, with the copy, the product surface and
// the extraction of every edge interleaved, for Hopper (sm_90a):
// CORR_KERNEL="full". Plain C interface, loaded with ctypes by
// devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded` (devo_tpu/ops/corr_pallas.py:289,
// reached through corr_level_banded :738 with ablate="full", pallas_call at
// :958; ablate="noext", "nomm" and "noDMA" are its stage ablations) together
// with its XLA glue: lookup_g (:968), the index preamble (:784-810) and
// ops/corr.blend_strips. What that kernel is: per edge, in one loop, a window
// copy out of a K-deep ring with IF copies in flight, one product of the
// window against the patch's pixels into one of four rotating result
// scratches, and the extraction of the pixels' tap strips from it. This kernel
// keeps that loop: a ring of `depth` window stages filled by cp.async, the
// product surface in one of two rotating f32 scratches, the extraction and
// blend in the same iteration. It keeps none of the TPU's shapes: plain (mem,
// h, w, C) rings, no bands, stagger or 24-wide windows; a window is the union
// of the pixels' 8x8 tap grids, and out-of-image positions are zero.
//
// What it computes, per edge, with coords already at this level's resolution:
// ops/corr.corr_level, unclipped; a window of more than `cap` positions (a
// strongly distorted patch; every window where cap = 0) is not staged and
// that edge reads its 64 taps a pixel from the ring. The stage instances
// time the loop's parts apart and compute no correlation; each writes what
// ops/corr.corr_level_stage defines:
//   kNoExt  copies and products, no extraction: a staged edge's row is the
//           first 49*P*P values of its surface; an edge not staged is 0
//   kNoMM   copies and extraction, no product: every tap is the ring value
//           of channel p % C of its position
//   kNoDMA  products and extraction over windows that are zeroed once and
//           never copied: a staged edge is 0; an edge not staged reads the
//           ring as in kFull.
//
// What bounds it on an H100: the bytes are those of csrc/corr_level.cu, but a
// thread that dots one window position with all nine pixels
// (position_products) still fills its registers with the whole patch feature
// from shared memory, about 1150 clocks a warp at C = 128, and that is the
// time. The stage instances exist to measure that split: copy, product and
// extraction. What the design does:
//   - a block of 160 threads (a window holds at most 144 positions) walks a
//     run of consecutive edges (the wrapper sizes the runs to whole rounds
//     over the SMs); the copies of edge e+depth-1 start before the products
//     of edge e, one commit group an edge;
//   - the ring is as deep as the shared memory of two blocks an SM allows on
//     bf16 rings (two stages at C = 128); on f32 rings one block takes an SM;
//   - the patch feature of edge e+1 and the coordinates of edge e+depth are
//     loaded into registers before the products of edge e and written to
//     shared memory after them (the patch feature as f32 into slot (e+1)%2,
//     the coordinates as the edge's index table, EdgePrep, by the last warp);
//   - one barrier an edge: slot e%2 of the scratch and of the tap buffer is
//     written before B(e) and read after it, and not written again before
//     B(e+1).
//
// Hazards, for the reader of the loop: one barrier B(e) an iteration, after
// the products and before the extraction. Stage (e-1)%depth is read by the
// products of e-1 (before B(e-1)) and written by the copies started at the
// top of iteration e. Slot e%2 of the scratch and of the tap buffer is
// written before B(e), read after it, and written again before B(e+2), by
// threads that have all passed B(e+1) and so finished the extraction of e.
// Patch feature slot (e+1)%2 is written after the products of e (its last
// readers, the products of e-1, are behind B(e-1)) and read after B(e).
// EdgePrep slot (e+depth)%(depth+2) is written in iteration e; its last
// occupant, edge e-2, was last read by the extraction of e-2, behind B(e-1).
// Under kNoMM the extraction of e reads stage e%depth after B(e), and the
// copies started at the top of iteration e+1 overwrite it: that instance has
// a second barrier an iteration, after the extraction.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 160;
constexpr int kMaxDepth = 4;
constexpr int kPrepSlots = kMaxDepth + 2;
constexpr int kHold = 2;               // Held4 registers a thread
constexpr int kTapCount = kTaps * kTaps;

enum Stage { kFull = 0, kNoExt = 1, kNoMM = 2, kNoDMA = 3 };

template <typename F>
struct FullArgs {
  PairArgs<F, F> p;
  int depth;                // stages of the window ring, 2 .. kMaxDepth
  int run;                  // consecutive edges a block walks
};

template <typename F>
__host__ __device__ inline size_t stage_bytes(int C, int cap) {
  return static_cast<size_t>(cap) * padded_stride<F>(C) * sizeof(F);
}

template <typename F, int kStage>
__global__ void __launch_bounds__(kThreads)
corr_level_full_kernel(const FullArgs<F> args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePrep prep[kPrepSlots];
  __shared__ __align__(16) float ce_next[2 * kMaxPP];
  const PairArgs<F, F>& a = args.p;
  const int PP = a.PP, C = a.C, cap = a.cap, H = a.H[0], W = a.W[0];
  const int depth = args.depth, slots = args.depth + 2;
  const int per_edge = PP * kTapCount;
  const int stride = padded_stride<F>(C);
  // the window ring first: its stages are multiples of 16 bytes, so every
  // part stays aligned for the 16-byte copies and loads
  const size_t per_stage = stage_bytes<F>(C, cap);
  unsigned char* stages = smem_raw;                   // (depth, cap, stride)
  float* gf = reinterpret_cast<float*>(stages + depth * per_stage);  // (2, PP, C)
  float* scr = gf + 2 * PP * C;                       // (2, cap, PP) f32
  float* tapbuf = scr + 2 * cap * PP;                 // (2, PP, 8, 8) f32

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int start = (kVec * lane) % C;
  const int n_out = kOut * kOut * PP;
  const int first = blockIdx.x * args.run;
  const int count = min(args.run, a.E - first);

  auto window = [&](int n) {
    return reinterpret_cast<F*>(stages + (n % depth) * per_stage);
  };
  auto ring_slot = [&](const EdgePrep& ep) {
    return a.fmap[0] + static_cast<size_t>(ep.frame) * H * W * C;
  };
  auto start_copies = [&](int n) {
    if (kStage == kNoDMA) return;
    const EdgePrep& ep = prep[n % slots];
    stage_window(window(n), ring_slot(ep), ep, 0, H, W, C, tid, kThreads,
                 stride);
  };
  auto gsrc = [&](int n) {
    return a.gmap + static_cast<size_t>(prep[n % slots].kk) * PP * C;
  };

  if (kStage == kNoDMA) {
    // the windows are read but never copied: zero them once
    const int n_words = static_cast<int>(depth * per_stage / 16);
    for (int i = tid; i < n_words; i += kThreads)
      reinterpret_cast<uint4*>(stages)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int n = warp; n < depth && n < count; n += kThreads / 32) {
    const size_t e = first + n;
    prep_edge<1>(prep[n], a, a.coords + e * PP * 2, a.kk[e], a.jj[e], lane);
  }
  __syncthreads();
  for (int i = tid * kVec; i < PP * C; i += kThreads * kVec) {
    Held4<F> h;
    h.load(gsrc(0) + i);
    h.store(gf + i);
  }
  for (int n = 0; n < depth - 1; ++n) {
    if (n < count) start_copies(n);
    cp_async_commit();
  }
  cp_async_wait_pending(depth - 2);     // this thread's copies of edge 0
  __syncthreads();

  for (int e = 0; e < count; ++e) {
    const EdgePrep& ep = prep[e % slots];
    if (e + depth - 1 < count) start_copies(e + depth - 1);
    cp_async_commit();              // a group every iteration, empty at the end

    // loads that the products hide: edge e+1's patch feature, and (last
    // warp) edge e+depth's coordinates and indices
    Held4<F> held[kHold];
    const bool more = e + 1 < count;
    if (more) {
#pragma unroll
      for (int h = 0; h < kHold; ++h) {
        const int i = (tid + h * kThreads) * kVec;
        if (i < PP * C) held[h].load(gsrc(e + 1) + i);
      }
    }
    const bool prep_ahead = warp == kThreads / 32 - 1 && e + depth < count;
    float2 c_next = make_float2(0.0f, 0.0f);
    int kk_next = 0, jj_next = 0;
    if (prep_ahead) {
      const size_t en = first + e + depth;
      if (lane < PP)
        c_next = *reinterpret_cast<const float2*>(a.coords + (en * PP + lane) * 2);
      kk_next = a.kk[en];
      jj_next = a.jj[en];
    }

    // the product surface of the staged window, or the taps from the ring
    const float* g = gf + (e & 1) * PP * C;
    float* surface = scr + (e & 1) * cap * PP;
    float* taps = tapbuf + (e & 1) * per_edge;
    const int ww = ep.ww[0];
    if (ww > 0) {
      if (kStage != kNoMM) {
        const F* win = window(e);
        const int n_pos = ww * ep.wh[0];
        for (int pos = tid; pos < n_pos; pos += kThreads) {
          const int r = pos / ww;
          const int iy = ep.wy0[0] + r;
          const int ix = ep.wx0[0] + pos - r * ww;
          float* dst = surface + pos * PP;
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
      }
    } else if (kStage != kNoExt) {
      const F* fbase = ring_slot(ep);
      for (int it = tid; it < per_edge; it += kThreads) {
        const int p = it / kTapCount;
        const int tap = it - p * kTapCount;
        const int iy = ep.y0[0][p] + tap / kTaps - kRadius;
        const int ix = ep.x0[0][p] + tap % kTaps - kRadius;
        float v = 0.0f;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
          const F* f = fbase + (static_cast<size_t>(iy) * W + ix) * C;
          v = kStage == kNoMM ? to_float(f[p % C])
                              : dot_rotated(g + p * C, f, C, start);
        }
        taps[it] = v;
      }
    }

    if (more) {
      float* gn = gf + ((e + 1) & 1) * PP * C;
#pragma unroll
      for (int h = 0; h < kHold; ++h) {
        const int i = (tid + h * kThreads) * kVec;
        if (i < PP * C) held[h].store(gn + i);
      }
      for (int i = (tid + kHold * kThreads) * kVec; i < PP * C;
           i += kThreads * kVec) {
        Held4<F> h;
        h.load(gsrc(e + 1) + i);
        h.store(gn + i);
      }
    }
    if (prep_ahead) {
      if (lane < PP) {
        ce_next[2 * lane] = c_next.x;
        ce_next[2 * lane + 1] = c_next.y;
      }
      __syncwarp();
      prep_edge<1>(prep[(e + depth) % slots], a, ce_next, kk_next, jj_next,
                   lane);
      __syncwarp();
    }
    cp_async_wait_pending(depth - 2);     // this thread's copies of edge e+1
    __syncthreads();                      // B(e)

    float* dst = a.out + static_cast<size_t>(first + e) * n_out;
    if constexpr (kStage == kNoExt) {
      // the surface's first values instead of the extraction
      const int n_val = ww > 0 ? ww * ep.wh[0] * PP : 0;
      for (int o = tid; o < n_out; o += kThreads)
        dst[o] = o < n_val ? surface[o] : 0.0f;
    } else {
      // extraction and blend: out[e][(ox * 7 + oy) * PP + p]
      for (int o = tid; o < n_out; o += kThreads) {
        const int p = o % PP;
        const int t = o / PP;
        const int ox = t / kOut, oy = t - ox * kOut;
        const float fx = ep.fx[0][p], fy = ep.fy[0][p];
        if (ww == 0) {
          dst[o] = blend_frac(taps + p * kTapCount, ox, oy, fx, fy);
          continue;
        }
        const int r = ep.y0[0][p] + oy - kRadius - ep.wy0[0];
        const int c = ep.x0[0][p] + ox - kRadius - ep.wx0[0];
        float s00, s01, s10, s11;
        if (kStage == kNoMM) {
          // channel p % C of the four positions, 0 off the image
          const F* win = window(e);
          float v[4];
          for (int i = 0; i < 4; ++i) {
            const int rr = r + (i >> 1), cc = c + (i & 1);
            const int iy = ep.wy0[0] + rr, ix = ep.wx0[0] + cc;
            v[i] = (iy < 0 || iy >= H || ix < 0 || ix >= W)
                       ? 0.0f
                       : to_float(win[static_cast<size_t>(rr * ww + cc) * stride + p % C]);
          }
          s00 = v[0]; s01 = v[1]; s10 = v[2]; s11 = v[3];
        } else {
          const float* s = surface + (r * ww + c) * PP + p;
          s00 = s[0]; s01 = s[PP]; s10 = s[ww * PP]; s11 = s[(ww + 1) * PP];
        }
        dst[o] = (1.0f - fx) * (1.0f - fy) * s00 + fx * (1.0f - fy) * s01 +
                 (1.0f - fx) * fy * s10 + fx * fy * s11;
      }
      // under kNoMM the extraction read stage e%depth, which the copies at
      // the top of iteration e+1 overwrite
      if (kStage == kNoMM) __syncthreads();
    }
  }
}

template <typename F, int kStage>
int launch(const FullArgs<F>& args, cudaStream_t st) {
  const PairArgs<F, F>& a = args.p;
  const size_t smem =
      (2 * static_cast<size_t>(a.PP) * a.C + 2 * static_cast<size_t>(a.cap) * a.PP +
       2 * a.PP * kTapCount) * sizeof(float) +
      args.depth * stage_bytes<F>(a.C, a.cap);
  const cudaError_t err =
      allow_shared_memory(corr_level_full_kernel<F, kStage>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.E + args.run - 1) / args.run;
  corr_level_full_kernel<F, kStage><<<grid, kThreads, smem, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

template <typename F>
int launch_stage(const FullArgs<F>& args, int stage, cudaStream_t st) {
  switch (stage) {
    case kFull: return launch<F, kFull>(args, st);
    case kNoExt: return launch<F, kNoExt>(args, st);
    case kNoMM: return launch<F, kNoMM>(args, st);
    case kNoDMA: return launch<F, kNoDMA>(args, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. gmap, fmap, coords, kk, jj, out, E, PP, C, H, W
// and `cap` are those of devo_corr_group8 (csrc/corr_group8.cu); `depth` is
// the number of stages of the window ring (2 .. 4), `run` the consecutive
// edges a block walks (at least 1), `stage` 0 = the correlation, 1 = no
// extraction, 2 = no product, 3 = no copy (ops/corr.corr_level_stage). The
// dynamic shared memory taken is that of ops/corr_cuda.full_smem_bytes.
extern "C" int devo_corr_level_full(const void* gmap, const void* fmap,
                                    const void* coords, const void* kk,
                                    const void* jj, void* out, int E, int PP,
                                    int C, int H, int W, int cap, int bf16,
                                    int depth, int run, int stage,
                                    void* stream) {
  if (E == 0) return 0;
  if (depth < 2 || depth > kMaxDepth || run < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(F)                                                        \
  launch_stage(FullArgs<F>{level_args<F, F>(gmap, fmap, nullptr, coords, kk,  \
                                            jj, out, E, PP, C, H, W, cap),    \
                           depth, run},                                       \
               stage, st)
  return bf16 ? DEVO_LAUNCH(__nv_bfloat16) : DEVO_LAUNCH(float);
#undef DEVO_LAUNCH
}
