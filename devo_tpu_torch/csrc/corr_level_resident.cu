// Level 4 of the sparse patch correlation, read from a ring slot that is
// resident in shared memory, for Hopper (sm_90a). Plain C interface, loaded
// with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_l4_resident`
// (devo_tpu/ops/corr_pallas.py:1042, reached through corr_level_l4_resident
// :1088, pallas_call at :1170) and its padded ring layout pad_frame_l4_i8
// (:1027). What the TPU kernel does: it copies the whole level-4 int8 ring
// into its fast memory once a call and slices every window out of it, with
// no copy an edge; its products run on the matrix unit into an R-buffer, an
// extraction pass follows. A block of this card has 227 KB of shared memory
// and one level-4 frame at 480x640 is 30 x 40 x 128 int8 = 153,600 bytes:
// one ring slot fits a block, the ring (4.9 MB) does not. The idea is kept:
// windows are never copied, every tap is read from a frame that stays in
// shared memory. int8 rings only, as on the TPU.
//
// What it computes is ops/corr.corr_level: per edge e the 8x8 integer-tap
// dots of gmap[kk[e]] around each pixel's floor coordinate in fmap[jj[e]],
// times the slot's scale dq[jj[e]] (f32, unrounded), blended to 7x7;
// (E, 49*P*P) f32 in [dx, dy, pixel] order, zero taps off the image.
//
// The design:
//   - The frame in shared memory, one row of `row` bytes a position (C
//     rounded up to whole chunks of 32 channels, zeros past C), each row in
//     16-byte chunks that are swizzled: chunk k of position pos lies at chunk
//     k ^ sigma(pos) (resident_swizzle). The tensor cores' fragment loads
//     read 8 bytes a lane from 8 window rows, and window rows are
//     consecutive positions `row` bytes apart, which unswizzled fall into the
//     same banks. sigma takes 4 consecutive positions to 4 distinct pairs of
//     chunks (the two chunks a row's lanes read in one phase of 16 lanes)
//     and 8 consecutive positions to 8 distinct chunks (the 16-byte reads of
//     a position a lane); k ^ (pos & 7) would put positions 2i and 2i + 1 on
//     one pair. A swizzle costs no bytes where padding each position to
//     mma_stride would leave room for at most 10 warps. After the frame, one
//     zero row: every window position off the image addresses it, so the
//     product needs no branch there. Every reader of the frame applies the
//     swizzle.
//   - One warp an edge, no block barrier between edges. The warp works out
//     the window that covers its pixels' tap grids (at level 4 at most 9x9
//     positions for an undistorted patch) and takes its m-tiles of 16
//     positions on mma.sync.m16n8k16 (corr_mma.cuh): the A rows addressed in
//     the frame one by one (tile_chunk_rows), the int8 -> bf16 conversion in
//     the fragment loads, the B words the patch feature read from device
//     memory (ChunkB::load_upto), all m-tiles' sums in registers. The sums,
//     times the slot's scale, go to the warp's f32 surface (store_tile); the
//     extraction and blend read it. A window beyond `cap` positions takes its
//     taps from the frame one dot a tap into the same scratch. f32 patch
//     features take the CUDA cores from the same frame: the warp stages the
//     patch feature as f32 and a lane takes a window position against every
//     pixel, or a tap where the window is beyond `cap`; that route holds
//     fewer warps (ops/corr_cuda.resident_plan).
//   - Persistent blocks over the slot-sorted edges: block b of B takes edges
//     [bE/B, (b+1)E/B) of the wrapper's slot-sorted `order` and walks them in
//     maximal runs of one slot: it copies that slot's frame (cp.async),
//     passes one barrier, its warps take the run's edges in turn, and one
//     barrier precedes the next frame. The work is balanced whatever the
//     distribution of jj, and at most B + slots - 1 frames are copied.
// Each output row is written by one warp in a fixed order: the same bits for
// any block count and any launch; no atomics.
//
// What bounds it on an H100: bytes (the (E, 49*P*P) f32 output, the patch
// features, the frames from L2), and below them each warp's chain of
// fragment loads with their int8 -> bf16 conversion, products and blend an
// edge, of which the 16 warps a block holds beside the frame hide little:
// the kernel alone takes about 7x its byte bound at E = 12288 (PERF.md).
// The chain divides by no run-time value: a window row from a reciprocal,
// the outputs walked 32 at a time, and the next chunk's B words load while
// this chunk's products run.

#include <climits>
#include <type_traits>

#include "corr_mma.cuh"

namespace {

using namespace devo;

constexpr int kMaxWarps = 16;                 // warps of a block, at most
constexpr int kMaxTiles = 6;                  // m-tiles of a window: cap <= 96
constexpr int kTableBytes = kMaxPP * 16;      // a warp's pixel table

// A pixel of the edge a warp holds: the floor and fraction of its coordinate.
struct Pixel {
  int x0, y0;
  float fx, fy;
};

// The swizzle of position pos's chunks (see the header), within `mask` + 1
// chunks: a power of two that divides the chunks of a row, at most 8.
__device__ __forceinline__ int resident_swizzle(int pos, int mask) {
  return (((pos & 3) << 1) | ((pos >> 2) & 1)) & mask;
}

// How a block lays out its shared memory: the frame (H * W rows of `row`
// bytes) and the zero row, then for each warp its surface slot (`slot`
// floats: cap rows of ss, or the PP x 64 taps), its pixel table and, for f32
// patch features, the patch feature as f32. ops/corr_cuda.resident_plan's
// sum is the same.
struct ResidentLayout {
  int row, nch, mask, ss, slot;
  size_t frame, slot_bytes, warp;
  __host__ __device__ ResidentLayout(int PP, int C, int H, int W, int cap,
                                     bool f32) {
    row = mma_channels(C);
    nch = row / 16;
    const int pow2 = nch & -nch;
    mask = (pow2 < 8 ? pow2 : 8) - 1;
    ss = surface_stride(PP);
    slot = cap * ss > PP * kTaps * kTaps ? cap * ss : PP * kTaps * kTaps;
    frame = (static_cast<size_t>(H) * W + 1) * row;
    slot_bytes = (static_cast<size_t>(slot) * sizeof(float) + 15) / 16 * 16;
    warp = slot_bytes + kTableBytes +
           (f32 ? static_cast<size_t>(PP) * C * sizeof(float) : 0);
  }
  __host__ __device__ size_t bytes(int warps) const {
    return frame + static_cast<size_t>(warps) * warp;
  }
};

// <g, frame row> over C channels by one thread: g (C elements of G, in
// device or shared memory), the row's 16-byte chunks at their swizzled
// places.
template <typename G>
__device__ __forceinline__ float frame_dot(const G* g, const int8_t* row,
                                           int sw, int C) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  for (int c = 0; c < C; c += 16) {
    float v[16];
    load_piece(reinterpret_cast<const int8_t*>(swizzled_at(row, sw, c)), v);
#pragma unroll
    for (int i = 0; i < 16; i += kVec) {
      float gv[kVec];
      load4(g + c + i, gv);
      a0 = fmaf(gv[0], v[i], a0);
      a1 = fmaf(gv[1], v[i + 1], a1);
      a2 = fmaf(gv[2], v[i + 2], a2);
      a3 = fmaf(gv[3], v[i + 3], a3);
    }
  }
  return (a0 + a1) + (a2 + a3);
}

// G: type of the patch features (bf16: the tensor cores; f32: the CUDA
// cores). `slots` holds jj in `order`'s order (the sorted slots), offsets
// (mem + 1) the first position of each slot in it.
template <typename G>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
corr_level_resident_kernel(const G* __restrict__ gmap,
                           const int8_t* __restrict__ fmap,
                           const float* __restrict__ dq,
                           const float* __restrict__ coords,
                           const int* __restrict__ kk,
                           const int* __restrict__ order,
                           const int* __restrict__ slots,
                           const int* __restrict__ offsets,
                           float* __restrict__ out, int E, int PP, int C,
                           int H, int W, int cap) {
  constexpr bool kBf16 = std::is_same<G, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ResidentLayout lay(PP, C, H, W, cap, !kBf16);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int8_t* const frame = reinterpret_cast<int8_t*>(smem_raw);
  const int zero_pos = H * W;                  // the zero row
  unsigned char* mine = smem_raw + lay.frame + warp * lay.warp;
  float* const surf = reinterpret_cast<float*>(mine);
  Pixel* const tab = reinterpret_cast<Pixel*>(mine + lay.slot_bytes);
  float* const gf = reinterpret_cast<float*>(mine + lay.slot_bytes + kTableBytes);
  const int n_out = kOut * kOut * PP;
  const int step_p = 32 % PP, step_t = 32 / PP;   // o += 32 as (t, p)
  const size_t frame_size = static_cast<size_t>(H) * W * C;

  const int lo = static_cast<int>(static_cast<long long>(blockIdx.x) * E / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(blockIdx.x + 1) * E / gridDim.x);
  if (lo >= hi) return;
  for (int i = threadIdx.x; i < lay.row / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(frame + static_cast<size_t>(zero_pos) * lay.row)[i] =
        make_uint4(0u, 0u, 0u, 0u);

  // a frame position's row and swizzle
  auto row_of = [&](int pos) { return frame + static_cast<size_t>(pos) * lay.row; };
  auto swz = [&](int pos) { return resident_swizzle(pos, lay.mask); };

  // the edge e of slot scale q, by this warp
  auto one_edge = [&](int e, float q) {
    const float* ce = coords + static_cast<size_t>(e) * PP * 2;
    int x0 = INT_MAX, y0 = INT_MAX, x1 = INT_MIN, y1 = INT_MIN;
    if (lane < PP) {
      const float2 c = *reinterpret_cast<const float2*>(ce + 2 * lane);
      x0 = x1 = floor_index(c.x);
      y0 = y1 = floor_index(c.y);
      tab[lane] = Pixel{x0, y0, c.x - floorf(c.x), c.y - floorf(c.y)};
    }
    const int xmin = __reduce_min_sync(~0u, x0), ymin = __reduce_min_sync(~0u, y0);
    const int xmax = __reduce_max_sync(~0u, x1), ymax = __reduce_max_sync(~0u, y1);
    const int ww = xmax - xmin + kTaps, wh = ymax - ymin + kTaps;
    const int wx0 = xmin - kRadius, wy0 = ymin - kRadius;
    const bool fits = static_cast<long long>(ww) * wh <= cap;
    const int n_pos = fits ? ww * wh : 0;
    const G* gsrc = gmap + static_cast<size_t>(kk[e]) * PP * C;
    // window position m's frame position: the zero row off the image and
    // past the window. m / ww by a reciprocal: m < cap <= 96, so (m + 0.5)
    // / ww lies at least 0.5 / ww from an integer, far beyond f32's error.
    const float inv_ww = __frcp_rn(static_cast<float>(ww));
    auto window_pos = [&](int m) {
      if (m >= n_pos) return zero_pos;
      const int r = __float2int_rz((m + 0.5f) * inv_ww);
      const int iy = wy0 + r, ix = wx0 + m - r * ww;
      return iy >= 0 && iy < H && ix >= 0 && ix < W ? iy * W + ix : zero_pos;
    };
    if constexpr (!kBf16) {
      for (int i = lane; i < PP * C / kVec; i += 32)
        reinterpret_cast<float4*>(gf)[i] = reinterpret_cast<const float4*>(gsrc)[i];
    }
    __syncwarp();                  // the pixel table and patch feature

    if (fits) {
      if constexpr (kBf16) {
        // the window's m-tiles on the tensor cores, every tile's sums in
        // registers while the chunks of the patch feature pass
        const int n_tiles = (n_pos + 15) / 16, g = lane >> 2;
        const int8_t* ra[kMaxTiles];
        const int8_t* rb[kMaxTiles];
        int sa[kMaxTiles], sb[kMaxTiles];
        float d[kMaxTiles][2][4] = {};
#pragma unroll
        for (int mt = 0; mt < kMaxTiles; ++mt) {
          const int pa = window_pos(mt * 16 + g), pb = window_pos(mt * 16 + g + 8);
          ra[mt] = row_of(pa); sa[mt] = swz(pa);
          rb[mt] = row_of(pb); sb[mt] = swz(pb);
        }
        // the next chunk's B words load while this chunk's products run
        ChunkB b;
        b.load_upto(gsrc, C, PP, 0, lane);
        for (int c0 = 0; c0 < lay.row; c0 += kMmaChunk) {
          ChunkB next;
          next.load_upto(gsrc, C, PP, c0 + kMmaChunk, lane);
#pragma unroll
          for (int mt = 0; mt < kMaxTiles; ++mt)
            if (mt < n_tiles)
              tile_chunk_rows(d[mt], ra[mt], sa[mt], rb[mt], sb[mt], c0, b, lane);
          b = next;
        }
#pragma unroll
        for (int mt = 0; mt < kMaxTiles; ++mt)
          if (mt < n_tiles) store_tile(surf, lay.ss, mt * 16, d[mt], PP, q, lane);
      } else {
        // a window position a lane, against every pixel
        for (int m = lane; m < n_pos; m += 32) {
          const int pos = window_pos(m);
          const int8_t* r = row_of(pos);
          const int sw = swz(pos);
          float acc[kMaxPP] = {};
          for (int c = 0; c < C; c += 16) {
            float v[16];
            load_piece(swizzled_at(r, sw, c), v);
#pragma unroll
            for (int p = 0; p < kMaxPP; ++p) {
              if (p >= PP) break;
              const float* gp = gf + p * C + c;
#pragma unroll
              for (int i = 0; i < 16; i += kVec) {
                const float4 gv = *reinterpret_cast<const float4*>(gp + i);
                acc[p] = fmaf(gv.x, v[i], acc[p]);
                acc[p] = fmaf(gv.y, v[i + 1], acc[p]);
                acc[p] = fmaf(gv.z, v[i + 2], acc[p]);
                acc[p] = fmaf(gv.w, v[i + 3], acc[p]);
              }
            }
          }
#pragma unroll
          for (int p = 0; p < kMaxPP; ++p)
            if (p < PP) surf[m * lay.ss + p] = acc[p] * q;
        }
      }
    } else {
      // a window beyond the cap: the taps from the frame, one dot a tap,
      // (PP, 8, 8)
      for (int it = lane; it < PP * kTaps * kTaps; it += 32) {
        const int p = it / (kTaps * kTaps), tap = it - p * kTaps * kTaps;
        const Pixel px = tab[p];
        const int iy = px.y0 + tap / kTaps - kRadius;
        const int ix = px.x0 + tap % kTaps - kRadius;
        float v = 0.0f;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
          const int pos = iy * W + ix;
          v = (kBf16 ? frame_dot(gsrc + static_cast<size_t>(p) * C, row_of(pos),
                                 swz(pos), C)
                     : frame_dot(gf + p * C, row_of(pos), swz(pos), C)) * q;
        }
        surf[it] = v;
      }
    }
    __syncwarp();                  // the surface

    // extraction and blend: out[e][(ox * 7 + oy) * PP + p], o = t * PP + p
    // walked 32 at a time without a division by PP
    float* dst = out + static_cast<size_t>(e) * n_out;
    int p = lane % PP, t = lane / PP;
    for (int o = lane; o < n_out; o += 32) {
      const int ox = t / kOut, oy = t % kOut;
      const Pixel px = tab[p];
      if (fits) {
        const int r = px.y0 + oy - kRadius - wy0;
        const int c = px.x0 + ox - kRadius - wx0;
        dst[o] = blend_at(surf + (r * ww + c) * lay.ss + p, lay.ss,
                          ww * lay.ss, px.fx, px.fy);
      } else {
        dst[o] = blend_frac(surf + p * kTaps * kTaps, ox, oy, px.fx, px.fy);
      }
      p += step_p;
      t += step_t;
      if (p >= PP) {
        p -= PP;
        ++t;
      }
    }
    __syncwarp();                  // before the next edge rewrites them
  };

  for (int i = lo; i < hi;) {
    // a maximal run of one slot: its frame, then its edges
    const int slot = slots[i];
    const int end = min(hi, offsets[slot + 1]);
    const int8_t* src = fmap + slot * frame_size;
    for (int k = threadIdx.x; k < H * W * lay.nch; k += blockDim.x) {
      const int pos = k / lay.nch, ch = k - pos * lay.nch;
      const bool valid = ch * 16 < C;
      cp_async_zfill<16>(frame + static_cast<size_t>(pos) * lay.row +
                             ((ch ^ swz(pos)) << 4),
                         valid ? src + static_cast<size_t>(pos) * C + ch * 16 : src,
                         valid);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();               // the frame has landed
    const float q = dq[slot];
    for (int k = i + warp; k < end; k += warps) one_edge(order[k], q);
    __syncthreads();               // the frame is read no more
    i = end;
  }
}

template <typename G>
int launch(const void* gmap, const void* fmap, const void* dq,
           const void* coords, const void* kk, const void* order,
           const void* slots, const void* offsets, void* out, int E, int PP,
           int C, int H, int W, int cap, int warps, int blocks,
           cudaStream_t st) {
  const size_t smem =
      ResidentLayout(PP, C, H, W, cap, !std::is_same<G, __nv_bfloat16>::value)
          .bytes(warps);
  const cudaError_t err =
      allow_shared_memory(corr_level_resident_kernel<G>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_level_resident_kernel<G><<<blocks, warps * 32, smem, st>>>(
      static_cast<const G*>(gmap), static_cast<const int8_t*>(fmap),
      static_cast<const float*>(dq), static_cast<const float*>(coords),
      static_cast<const int*>(kk), static_cast<const int*>(order),
      static_cast<const int*>(slots), static_cast<const int*>(offsets),
      static_cast<float*>(out), E, PP, C, H, W, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C), bf16 if g_bf16 else f32;
// fmap (mem, H, W, C) int8; dq (mem,) f32 slot scales; coords (E, P, P, 2)
// f32 at this level's resolution; kk (E,) int32; order (E,) int32, the
// edges sorted by ring slot, and slots (E,) int32 their slots in that order;
// offsets (mem + 1,) int32, slot s owning order[offsets[s] :
// offsets[s + 1]]; out (E, 49*P*P) f32, of which every row is written. C is
// a multiple of 16, P*P at most 16, `cap` the window positions taken as a
// surface (at most 96, a multiple of 16 for bf16 patch features), `warps`
// 1 to 16 a block, `blocks` the persistent grid. The dynamic shared memory
// taken is devo_corr_level_resident_smem's, that of
// ops/corr_cuda.resident_plan.
extern "C" int devo_corr_level_resident(const void* gmap, const void* fmap,
                                        const void* dq, const void* coords,
                                        const void* kk, const void* order,
                                        const void* slots, const void* offsets,
                                        void* out, int E, int PP, int C, int H,
                                        int W, int cap, int g_bf16, int warps,
                                        int blocks, void* stream) {
  if (E == 0) return 0;
  if (PP > kMaxPP || C % 16 != 0 || warps < 1 || warps > kMaxWarps ||
      blocks < 1 || cap < 0 || cap > kMaxTiles * 16 ||
      (g_bf16 && cap % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    return launch<__nv_bfloat16>(gmap, fmap, dq, coords, kk, order, slots,
                                 offsets, out, E, PP, C, H, W, cap, warps,
                                 blocks, st);
  return launch<float>(gmap, fmap, dq, coords, kk, order, slots, offsets, out,
                       E, PP, C, H, W, cap, warps, blocks, st);
}

// The dynamic shared memory devo_corr_level_resident takes at these sizes.
extern "C" long long devo_corr_level_resident_smem(int PP, int C, int H, int W,
                                                   int cap, int g_bf16,
                                                   int warps) {
  return static_cast<long long>(
      ResidentLayout(PP, C, H, W, cap, !g_bf16).bytes(warps));
}
