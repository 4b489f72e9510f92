// What the correlation kernels of devo_tpu_torch share: the tap-grid
// constants, the coordinate floor, loads of four consecutive channels of a
// feature vector as floats (f32, bf16 or int8 storage), the per-thread dot
// product over the channels, the bilinear blend, and the launch helper that
// opts a kernel in to more than 48 KB of dynamic shared memory; and, for the
// two kernels that take both pyramid levels of an edge in one block
// (corr_pair.cu, corr_pair2.cu), the asynchronous copies, the per-edge index
// table, the staging of a level's window, one tap's dot and the blended row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace devo {

constexpr int kRadius = 3;
constexpr int kTaps = 2 * kRadius + 2;     // 8x8 integer taps
constexpr int kOut = 2 * kRadius + 1;      // 7x7 blended offsets
constexpr int kVec = 4;                    // channels per vector load

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// floor of a coordinate as an int; far-off values are clamped first (they
// are out of bounds either way) so the conversion cannot overflow
__device__ __forceinline__ int floor_index(float v) {
  return static_cast<int>(floorf(fminf(fmaxf(v, -1.0e6f), 1.0e6f)));
}

// four consecutive channels as floats; p is aligned to four elements
__device__ __forceinline__ void load4(const float* p, float (&v)[kVec]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// int8 -> float without the conversion unit, whose rate bounds a kernel that
// converts every ring byte: flip the sign bits (the value + 128 as an
// unsigned byte u), put u into the low mantissa byte of 2^23 (0x4B000000, so
// the float is 2^23 + u) and subtract 2^23 + 128. Exact for every int8.
__device__ __forceinline__ void load4(const int8_t* p, float (&v)[kVec]) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p) ^ 0x80808080u;
  constexpr float kBias = 8388608.0f + 128.0f;
  v[0] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - kBias;
  v[1] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - kBias;
  v[2] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7652)) - kBias;
  v[3] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7653)) - kBias;
}

// <g, f> over C channels by one thread. g is f32 in shared memory, f a
// feature vector in shared or device memory. The walk starts at channel
// `start` (a multiple of 4 below C) and wraps: with start = 4 * lane the
// lanes of a warp, each on its own vector, touch different shared-memory
// banks in every step although the vectors lie C elements apart.
template <typename F>
__device__ __forceinline__ float dot_rotated(const float* g, const F* f, int C,
                                             int start) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  int c = start;
#pragma unroll 4
  for (int i = 0; i < C; i += kVec) {
    const float4 gv = *reinterpret_cast<const float4*>(g + c);
    float v[kVec];
    load4(f + c, v);
    a0 = fmaf(gv.x, v[0], a0);
    a1 = fmaf(gv.y, v[1], a1);
    a2 = fmaf(gv.z, v[2], a2);
    a3 = fmaf(gv.w, v[3], a3);
    c += kVec;
    if (c >= C) c = 0;
  }
  return (a0 + a1) + (a2 + a3);
}

// The 7x7 bilinear blend of one pixel's 8x8 integer taps at output offset
// (ox, oy), with the fractional parts (fx, fy) of the pixel's coordinate.
__device__ __forceinline__ float blend_frac(const float* taps8x8, int ox, int oy,
                                            float fx, float fy) {
  const float* tp = taps8x8 + oy * kTaps + ox;
  return (1.0f - fx) * (1.0f - fy) * tp[0] + fx * (1.0f - fy) * tp[1] +
         (1.0f - fx) * fy * tp[kTaps] + fx * fy * tp[kTaps + 1];
}

// The same from the coordinate itself.
__device__ __forceinline__ float blend_tap(const float* taps8x8, int ox, int oy,
                                           float x, float y) {
  return blend_frac(taps8x8, ox, oy, x - floorf(x), y - floorf(y));
}

constexpr size_t kDefaultSharedMemory = 48 * 1024;

// Allow `kernel` the dynamic shared memory `bytes` where that is more than
// the 48 KB a launch gets by default. The attribute belongs to the kernel on
// the current device, so it is set before every such launch (a cheap call)
// and nothing is remembered across devices.
template <typename Kernel>
inline cudaError_t allow_shared_memory(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSharedMemory) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// ---------------------------------------------------------------------------
// The two-level kernels with one block per edge at a time (corr_pair.cu,
// corr_pair2.cu).

// Asynchronous copies from device to shared memory (cp.async): the data goes
// past the registers, and a thread goes on while its copies fly. Copies
// started between two commits form a group; wait<N> returns once all but the
// thread's N newest groups have landed. Another thread sees the data after
// the __syncthreads() that follows its owner's wait. Source and destination
// are aligned to the size of the copy.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kMaxPP = 16;      // pixels of a patch the index table holds

// The arguments of a two-level kernel. G: type of the patch features, F:
// type of the rings. coords is at level-1 resolution; level l divides it by
// lvl[l], in the kernel, as csrc/corr.cu does.
template <typename G, typename F>
struct PairArgs {
  const G* gmap;            // (Mring, PP, C)
  const F* fmap[2];         // (mem, H[l], W[l], C)
  const float* dq[2];       // (mem,) scales of an int8 ring, else null
  const float* coords;      // (E, PP, 2)
  const int* kk;            // (E,)
  const int* jj;            // (E,)
  float* out;               // (E, 2 * 49 * PP)
  int E, PP, C;
  int H[2], W[2];
  float lvl[2];
  int cap;                  // feature vectors a staged window may hold
};

// What a block knows of one edge before it touches a ring: per level and
// pixel the floor and the fraction of the coordinate, and per level the
// window that covers the pixels' 8x8 tap grids (origin and extent; ww = 0
// where the window is beyond `cap` and the taps read the ring directly) and
// the ring slot's scale.
struct EdgePrep {
  int kk, frame;
  int x0[2][kMaxPP], y0[2][kMaxPP];
  float fx[2][kMaxPP], fy[2][kMaxPP];
  int wx0[2], wy0[2], ww[2], wh[2];
  float q[2];
};

// Fill `ep` for the edge with coordinates ce (PP x [x, y], in device or
// shared memory) and ring indices kk, jj. Called by every lane of one warp;
// the caller synchronises the block before another warp reads `ep`.
template <typename G, typename F>
__device__ __forceinline__ void prep_edge(EdgePrep& ep, const PairArgs<G, F>& a,
                                          const float* ce, int kk, int jj,
                                          int lane) {
  const int PP = a.PP;
  for (int t = lane; t < 2 * PP; t += 32) {
    const int lvl = t / PP;
    const int p = t - lvl * PP;
    const float s = lvl ? a.lvl[1] : a.lvl[0];
    const float x = ce[2 * p] / s;
    const float y = ce[2 * p + 1] / s;
    ep.x0[lvl][p] = floor_index(x);
    ep.y0[lvl][p] = floor_index(y);
    ep.fx[lvl][p] = x - floorf(x);
    ep.fy[lvl][p] = y - floorf(y);
  }
  __syncwarp();
  if (lane < 2) {
    const int lvl = lane;
    int xmin = 0x7fffffff, xmax = -0x7fffffff, ymin = xmin, ymax = xmax;
    for (int p = 0; p < PP; ++p) {
      xmin = min(xmin, ep.x0[lvl][p]); xmax = max(xmax, ep.x0[lvl][p]);
      ymin = min(ymin, ep.y0[lvl][p]); ymax = max(ymax, ep.y0[lvl][p]);
    }
    const int ww = xmax - xmin + kTaps;
    const int wh = ymax - ymin + kTaps;
    ep.wx0[lvl] = xmin - kRadius;
    ep.wy0[lvl] = ymin - kRadius;
    ep.ww[lvl] = static_cast<long long>(ww) * wh <= a.cap ? ww : 0;
    ep.wh[lvl] = wh;
    const float* dq = lvl ? a.dq[1] : a.dq[0];
    ep.q[lvl] = dq ? dq[jj] : 1.0f;
  }
  if (lane == 0) { ep.kk = kk; ep.frame = jj; }
}

// Start the copies of level `lvl`'s window of the edge into `win`
// ((cap, C), 16-byte aligned), by all `nthreads` threads of the block; a
// feature vector is a multiple of 16 bytes wherever cap > 0. Positions off
// the image stay unwritten: no tap reads them. The caller commits the group.
template <typename F>
__device__ __forceinline__ void stage_window(F* win, const F* fbase,
                                             const EdgePrep& ep, int lvl, int H,
                                             int W, int C, int tid,
                                             int nthreads) {
  const int ww = ep.ww[lvl];
  if (ww == 0) return;
  const int wx0 = ep.wx0[lvl];
  const int wy0 = ep.wy0[lvl];
  constexpr int kChunk = 16 / sizeof(F);    // elements per 16-byte copy
  const int chunks = C / kChunk;            // per feature vector
  const int n = ww * ep.wh[lvl] * chunks;
  for (int i = tid; i < n; i += nthreads) {
    const int pos = i / chunks;
    const int ch = (i - pos * chunks) * kChunk;
    const int r = pos / ww;
    const int iy = wy0 + r;
    const int ix = wx0 + pos - r * ww;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      cp_async16(win + static_cast<size_t>(pos) * C + ch,
                 fbase + (static_cast<size_t>(iy) * W + ix) * C + ch);
  }
}

// One integer tap of pixel p at level `lvl`: <g[p], ring vector> times the
// slot's scale, 0 off the image; from the staged window `win` or, where the
// window was not staged, from the ring slot `fbase`.
template <typename F>
__device__ __forceinline__ float pair_tap(const float* g, const F* win,
                                          const F* fbase, const EdgePrep& ep,
                                          int lvl, int p, int tap, int H, int W,
                                          int C, int start) {
  const int iy = ep.y0[lvl][p] + tap / kTaps - kRadius;
  const int ix = ep.x0[lvl][p] + tap % kTaps - kRadius;
  if (iy < 0 || iy >= H || ix < 0 || ix >= W) return 0.0f;
  const float* gp = g + p * C;
  const int ww = ep.ww[lvl];
  float acc;
  if (ww > 0)
    acc = dot_rotated(
        gp,
        win + static_cast<size_t>((iy - ep.wy0[lvl]) * ww + (ix - ep.wx0[lvl])) * C,
        C, start);
  else
    acc = dot_rotated(gp, fbase + (static_cast<size_t>(iy) * W + ix) * C, C,
                      start);
  return acc * ep.q[lvl];
}

// The edge's output row from its taps ((2, PP, 8, 8) in shared memory):
// dst[((ox * 7 + oy) * PP + p) * 2 + lvl], by all threads of the block.
__device__ __forceinline__ void blend_pair_row(float* dst, const float* taps,
                                               const EdgePrep& ep, int PP,
                                               int tid, int nthreads) {
  const int n_out = 2 * kOut * kOut * PP;
  for (int o = tid; o < n_out; o += nthreads) {
    const int lvl = o & 1;
    const int q = o >> 1;
    const int p = q % PP;
    const int t = q / PP;
    dst[o] = blend_frac(taps + (lvl * PP + p) * kTaps * kTaps, t / kOut,
                        t % kOut, ep.fx[lvl][p], ep.fy[lvl][p]);
  }
}

// Typed arguments from the C interface's untyped ones.
template <typename G, typename F>
inline PairArgs<G, F> pair_args(const void* gmap, const void* fmap1,
                                const void* fmap2, const void* dq1,
                                const void* dq2, const void* coords,
                                const void* kk, const void* jj, void* out,
                                int E, int PP, int C, int h1, int w1, int h2,
                                int w2, int cap, float lvl1, float lvl2) {
  PairArgs<G, F> a;
  a.gmap = static_cast<const G*>(gmap);
  a.fmap[0] = static_cast<const F*>(fmap1);
  a.fmap[1] = static_cast<const F*>(fmap2);
  a.dq[0] = static_cast<const float*>(dq1);
  a.dq[1] = static_cast<const float*>(dq2);
  a.coords = static_cast<const float*>(coords);
  a.kk = static_cast<const int*>(kk);
  a.jj = static_cast<const int*>(jj);
  a.out = static_cast<float*>(out);
  a.E = E; a.PP = PP; a.C = C;
  a.H[0] = h1; a.W[0] = w1; a.H[1] = h2; a.W[1] = w2;
  a.lvl[0] = lvl1; a.lvl[1] = lvl2;
  a.cap = cap;
  return a;
}

}  // namespace devo
