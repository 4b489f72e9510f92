// Both pyramid levels of the sparse patch correlation in one launch, from a
// per-edge product surface held in shared memory, for Hopper (sm_90a). Plain
// C interface, loaded with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_banded_mono3`
// (devo_tpu/ops/corr_pallas.py:1736, reached through corr_pyramid_banded
// :1962 -> corr_pyramid_pair2 :1835, pallas_call at :1944, variant="mono3")
// together with its XLA glue: lookup_g (:968), _pair_level_index (:1195), the
// one-hot scale lookup and ops/corr.blend_strips for both levels. What that
// kernel is: the mono kernel's function with a two-slot rotating per-edge f32
// product scratch a level, the extraction in the same iteration as the
// product (no lagged output block), 64 edges a block and a deep ring of window
// copies ahead of the products. This kernel keeps that and none of the TPU's
// shapes: plain (mem, h, w, C) rings, no bands, stagger, 24-wide windows or
// bf16 strip output; out-of-image positions are zero by a bounds check, and
// the blended (E, 882) f32 feature is written here.
//
// What it computes: the function of csrc/corr.cu (ops/corr.corr_pyramid is
// the plain version), coords / lvl divided here so that both floor the same
// values.
//
// What bounds it on an H100: bytes, and far above the byte bound the traffic
// from shared memory into the registers. A thread takes one position of the
// edge's covering window and dots its vector with all nine pixels of the
// patch (position_products): the window vector leaves shared memory once
// for nine dots, but every thread still needs every value of the patch
// feature in a register, and shared memory fills 32 lanes x 4 bytes a clock
// whether the lanes read one address (a broadcast, as here) or 32: P*P x C
// floats a thread are P*P x C / 32 x 32 = 1152 clocks a warp and level at
// C = 128, about 9k clocks an edge, which is what the kernel takes (see
// PERF.md). Several positions a thread, so that a value of the patch feature
// serves them all from one register, or the tensor cores, are the way
// below that; this version does not take it. What the design does:
//   - the product surface as said; windows lie in shared memory with their
//     vectors 16 bytes further apart than they are long, which spreads the
//     lanes' 16-byte reads over the banks. 288 threads: 144 positions a
//     level;
//   - the surface, (positions, P*P) f32 a level, goes into slot e%2 of a
//     small scratch in shared memory and never to device memory; after one
//     barrier the same iteration takes each output's four taps from it,
//     blends, scales and writes the edge's row. The products of edge e+1 go
//     to the other slot, so that one barrier an edge is all the scratch
//     needs;
//   - a block walks a run of consecutive edges (at most 64; the wrapper
//     sizes the runs to whole rounds over the SMs) with a ring of `depth`
//     stages of windows:
//     the copies (cp.async) of edge e+depth-1 start before the products of
//     edge e, one commit group an edge. The ring is as deep as a block's
//     shared memory allows (the wrapper computes it: four stages on int8
//     rings at C = 128, two on bf16 rings);
//   - nothing else waits on device memory either: the patch feature of edge
//     e+1 and the coordinates of edge e+depth are loaded into registers
//     before the products of edge e and written to shared memory after them
//     (the patch feature as f32 into slot (e+1)%2, the coordinates as the
//     edge's index table, EdgePrep, by the warp with the fewest positions);
//   - a level whose window exceeds `cap` (a strongly distorted patch), or a
//     ring whose feature vector is no multiple of 16 bytes (cap = 0), takes
//     its 576 taps from the ring, one dot a tap, into a small tap buffer.
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

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kHalf = 144;             // threads a level
constexpr int kThreads = 2 * kHalf;
constexpr int kMaxDepth = 8;
constexpr int kPrepSlots = kMaxDepth + 2;
constexpr int kHold = 2;               // Held4 registers a thread

template <typename G, typename F>
struct Mono3Args {
  PairArgs<G, F> p;
  int depth;                // stages of the window ring, 2 .. kMaxDepth
  int run;                  // consecutive edges a block walks
};

// bytes of one stage: both levels' windows with padded vectors
template <typename F>
__host__ __device__ inline size_t stage_bytes(int C, int cap) {
  return 2 * static_cast<size_t>(cap) * padded_stride<F>(C) * sizeof(F);
}

template <typename G, typename F>
__global__ void __launch_bounds__(kThreads)
corr_mono3_kernel(const Mono3Args<G, F> args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePrep prep[kPrepSlots];
  __shared__ __align__(16) float ce_next[2 * kMaxPP];
  const PairArgs<G, F>& a = args.p;
  const int PP = a.PP, C = a.C, cap = a.cap;
  const int depth = args.depth, slots = args.depth + 2;
  const int per_level = PP * kTaps * kTaps;
  const int stride = padded_stride<F>(C);
  float* gf = reinterpret_cast<float*>(smem_raw);     // (2, PP, C) f32
  float* scr = gf + 2 * PP * C;                       // (2, 2, cap, PP) f32
  float* tapbuf = scr + 4 * cap * PP;                 // (2, 2, PP, 8, 8) f32
  unsigned char* stages = reinterpret_cast<unsigned char*>(tapbuf + 4 * per_level);
  const size_t per_stage = stage_bytes<F>(C, cap);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int my_lvl = tid >= kHalf;
  const int my_t = tid - my_lvl * kHalf;
  const int start = (kVec * lane) % C;
  const int n_out = 2 * kOut * kOut * PP;
  const int first = blockIdx.x * args.run;
  const int count = min(args.run, a.E - first);

  auto window = [&](int n, int lvl) {
    return reinterpret_cast<F*>(stages + (n % depth) * per_stage) +
           static_cast<size_t>(lvl) * cap * stride;
  };
  auto ring_slot = [&](const EdgePrep& ep, int lvl) {
    return a.fmap[lvl] + static_cast<size_t>(ep.frame) * a.H[lvl] * a.W[lvl] * C;
  };
  // the copies of this block's n-th edge into stage n % depth
  auto start_copies = [&](int n) {
    const EdgePrep& ep = prep[n % slots];
    for (int lvl = 0; lvl < 2; ++lvl)
      stage_window(window(n, lvl), ring_slot(ep, lvl), ep, lvl, a.H[lvl],
                   a.W[lvl], C, tid, kThreads, stride);
  };
  auto gsrc = [&](int n) {
    return a.gmap + static_cast<size_t>(prep[n % slots].kk) * PP * C;
  };

  // the index tables of the first `depth` edges, a warp each, and edge 0's
  // patch feature, straight from device memory
  for (int n = warp; n < depth && n < count; n += kThreads / 32) {
    const size_t e = first + n;
    prep_edge(prep[n], a, a.coords + e * PP * 2, a.kk[e], a.jj[e], lane);
  }
  __syncthreads();
  for (int i = tid * kVec; i < PP * C; i += kThreads * kVec) {
    Held4<G> h;
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
    Held4<G> held[kHold];
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

    // the product surface of this thread's level
    const float* g = gf + (e & 1) * PP * C;
    float* taps = tapbuf + (e & 1) * 2 * per_level;
    {
      const int lvl = my_lvl;
      const int ww = ep.ww[lvl];
      if (ww > 0) {
        float* surface = scr + ((e & 1) * 2 + lvl) * cap * PP;
        const F* win = window(e, lvl);
        const int n_pos = ww * ep.wh[lvl];
        for (int pos = my_t; pos < n_pos; pos += kHalf) {
          const int r = pos / ww;
          const int iy = ep.wy0[lvl] + r;
          const int ix = ep.wx0[lvl] + pos - r * ww;
          float* dst = surface + pos * PP;
          if (iy < 0 || iy >= a.H[lvl] || ix < 0 || ix >= a.W[lvl]) {
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
        const F* fbase = ring_slot(ep, lvl);
        for (int it = my_t; it < per_level; it += kHalf)
          taps[lvl * per_level + it] =
              pair_tap(g, static_cast<const F*>(nullptr), fbase, ep, lvl,
                       it / (kTaps * kTaps), it % (kTaps * kTaps), a.H[lvl],
                       a.W[lvl], C, start);
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
        Held4<G> h;
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
      prep_edge(prep[(e + depth) % slots], a, ce_next, kk_next, jj_next, lane);
      __syncwarp();
    }
    cp_async_wait_pending(depth - 2);   // this thread's copies of edge e+1
    __syncthreads();                    // B(e)

    // extraction, blend and scale, from the scratch or the tap buffer
    float* dst = a.out + static_cast<size_t>(first + e) * n_out;
    for (int o = tid; o < n_out; o += kThreads) {
      const int lvl = o & 1;
      const int q = o >> 1;
      const int p = q % PP;
      const int t = q / PP;
      const int ox = t / kOut, oy = t - ox * kOut;
      const float fx = ep.fx[lvl][p], fy = ep.fy[lvl][p];
      const int ww = ep.ww[lvl];
      if (ww > 0) {
        const int r = ep.y0[lvl][p] + oy - kRadius - ep.wy0[lvl];
        const int c = ep.x0[lvl][p] + ox - kRadius - ep.wx0[lvl];
        const float* s =
            scr + ((e & 1) * 2 + lvl) * cap * PP + (r * ww + c) * PP + p;
        dst[o] = ((1.0f - fx) * (1.0f - fy) * s[0] + fx * (1.0f - fy) * s[PP] +
                  (1.0f - fx) * fy * s[ww * PP] + fx * fy * s[(ww + 1) * PP]) *
                 ep.q[lvl];
      } else {
        dst[o] = blend_frac(taps + (lvl * PP + p) * kTaps * kTaps, ox, oy, fx, fy);
      }
    }
  }
}

template <typename G, typename F>
int launch(const Mono3Args<G, F>& args, cudaStream_t st) {
  const PairArgs<G, F>& a = args.p;
  const size_t smem =
      (2 * static_cast<size_t>(a.PP) * a.C + 4 * static_cast<size_t>(a.cap) * a.PP +
       4 * a.PP * kTaps * kTaps) * sizeof(float) +
      args.depth * stage_bytes<F>(a.C, a.cap);
  const cudaError_t err = allow_shared_memory(corr_mono3_kernel<G, F>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (a.E + args.run - 1) / args.run;
  corr_mono3_kernel<G, F><<<grid, kThreads, smem, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. The arguments are those of devo_corr_pair
// (csrc/corr_pair.cu), and `depth`, the stages of the window ring (2 .. 8),
// and `run`, the consecutive edges a block walks (at least 1). The dynamic
// shared memory taken is that of ops/corr_cuda.mono3_smem_bytes.
extern "C" int devo_corr_mono3(const void* gmap, const void* fmap1,
                               const void* fmap2, const void* dq1,
                               const void* dq2, const void* coords,
                               const void* kk, const void* jj, void* out, int E,
                               int PP, int C, int h1, int w1, int h2, int w2,
                               int cap, float lvl1, float lvl2, int g_bf16,
                               int ring_i8, int depth, int run, void* stream) {
  if (E == 0) return 0;
  if (depth < 2 || depth > kMaxDepth || run < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DEVO_LAUNCH(G, F)                                                     \
  launch(Mono3Args<G, F>{pair_args<G, F>(gmap, fmap1, fmap2, dq1, dq2,        \
                                         coords, kk, jj, out, E, PP, C, h1,   \
                                         w1, h2, w2, cap, lvl1, lvl2),        \
                         depth, run},                                         \
         st)
  if (g_bf16)
    return ring_i8 ? DEVO_LAUNCH(__nv_bfloat16, int8_t)
                   : DEVO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
  return ring_i8 ? DEVO_LAUNCH(float, int8_t) : DEVO_LAUNCH(float, float);
#undef DEVO_LAUNCH
}
