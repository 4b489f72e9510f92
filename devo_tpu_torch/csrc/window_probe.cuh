// What the two window-product probes share (csrc/corr_band_ablate.cu,
// csrc/corr_frame_probe.cu): per edge a window of 16 rows x 24 columns of
// bf16 feature vectors (C = 128), multiplied with the edge's 16 patch rows
// into the product surface R (384 positions x 16, f32) on the tensor cores,
// and read out in one of the output layouts of ops/probe.py. A front end
// (the caller's type) says which edges are computed, in what order, and
// where an edge's window lies.
//
// The design, for the H100:
//   - persistent blocks of 256 threads (8 warps), WINDOW_BLOCKS = 2 an SM
//     (ops/probe_cuda.window_plan), over the edges in the front's order:
//     with groups of one, block b takes edges b, b + grid, b + 2 grid, ...
//     (blocks that run at once read neighbouring edges' windows); with
//     larger groups, the b-th of `grid` equal runs of the order. Every
//     output element of an edge is written by one block, its sums in a
//     fixed order, so the bits depend neither on the grid nor on the groups;
//   - the block walks its edges in groups of up to kGroup consecutive edges
//     that share a window origin (kGroup = 1: every edge alone). A group's
//     window is staged by cp.async in chunks of 32 channels (384 positions
//     x 64 bytes, 24 KB a stage, with a hint that L2 fetch 128 bytes from
//     device memory at once) through a ring of `depth` stages; the block's
//     (group, chunk) steps form one stream, the copies of step s + depth - 1
//     fly while the warps multiply step s, one barrier a step. At the first
//     step of a group the next group's patch rows (bf16, mma_stride rows)
//     and strip offsets (ry, rx) are copied, two buffers by the group's
//     parity;
//   - the product on mma.sync.m16n8k16 (bf16 in, f32 sums) with the
//     fragments of csrc/corr_mma.cuh's channel order: each warp holds three
//     m-tiles of 16 positions, loads their A fragments once a chunk and
//     multiplies them with both n-tiles of every edge of the group; 384
//     mma.sync an edge. A chunk's rows are 64 bytes apart, so the 8 lanes
//     of one shared-memory phase (rows g and g + 1, pieces 0-3) read 128
//     contiguous bytes: no conflict;
//   - after a group's last chunk, edge by edge, each warp writes its
//     accumulators to the f32 surface, stored by column (pixel) with rows
//     388 floats apart (the lanes' 32 scalar stores hit 32 banks; the strip
//     modes store the 9 columns they read); one barrier, then the block
//     writes the edge's output from the surface, and one more before the
//     next edge's surface (the next group's first step barrier serves the
//     last edge).
//
// The ablation's modes keep the work each one measures, edge by edge
// (kGroup = 1): "nomm" copies every chunk of every window and multiplies
// nothing (its output is read from the staged chunks); "noext" multiplies
// everything and extracts nothing; "noDMA" multiplies every chunk of a
// window zeroed once and never copied (the patch rows are still copied).
// All modes take the same launch shape and shared memory.
#pragma once

#include <algorithm>

#include "corr_mma.cuh"

namespace devo {
namespace window_probe {

constexpr int kC = 128;                    // channels
constexpr int kRows = 16;                  // window rows
constexpr int kCols = 24;                  // window columns
constexpr int kPositions = kRows * kCols;  // 384
constexpr int kPix = 16;                   // patch rows multiplied
constexpr int kStrip = 9;                  // pixels whose strips are read
constexpr int kOutW = 16 * kStrip;         // 144
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpTiles = kPositions / 16 / kWarps;   // m-tiles a warp: 3
constexpr int kBlocksPerSm = 2;            // ops/probe_cuda.WINDOW_BLOCKS
constexpr int kChunks = kC / kMmaChunk;    // steps a group: 4
constexpr int kChunkPieces = kMmaChunk * 2 / 16;       // 16-byte pieces of a
                                                       // position's chunk
constexpr int kStageElems = kPositions * kMmaChunk;    // bf16 of a stage
constexpr int kGStride = mma_stride(kC);               // 160
constexpr int kGElems = kPix * kGStride;               // one edge's patch rows
constexpr int kSurfStride = kPositions + 4;            // 388 = 4 (mod 32)
constexpr int kMaxDepth = 4;
static_assert(kThreads * 8 == kPix * kC, "one 16-byte piece of g a thread");
static_assert(kThreads == 8 * kMmaChunk, "one window value a thread a chunk");

// cp.async of 16 bytes that asks L2 to fetch the source's 128-byte region
// from device memory at once: a window position's vector (256 bytes) is
// staged in four chunks of 64 bytes at four steps, which without the hint
// reach device memory as four requests far apart in time.
__device__ __forceinline__ void cp_async16_l2_128(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// the output layouts (ops/probe.py)
enum Mode { kFull = 0, kNoExt = 1, kNoMM = 2, kNoDMA = 3, kSurfaceRows = 4 };

__host__ __device__ constexpr int out_rows(int mode) {
  return mode == kSurfaceRows ? kRows : 8;
}

// Dynamic shared memory of a block (ops/probe_cuda.window_smem_bytes is the
// same sum): the stages, two groups' patch rows and offsets (ry, rx), the
// surface.
inline size_t smem_bytes(int depth, int group) {
  return (static_cast<size_t>(depth) * kStageElems +
          2 * static_cast<size_t>(group) * kGElems) *
             sizeof(__nv_bfloat16) +
         2 * static_cast<size_t>(group) * 2 * kPix * sizeof(int) +
         static_cast<size_t>(kPix) * kSurfStride * sizeof(float);
}

// Whether a mode reads the pixels' strips (and so the offsets ry, rx and
// the surface's first kStrip columns alone).
__host__ __device__ constexpr bool strips(int mode) {
  return mode == kFull || mode == kNoDMA;
}

// The accumulators of the m-tile at m0 into the surface by column: row
// m0 + g and m0 + g + 8, columns 8n + 2t and 8n + 2t + 1; with kStrips only
// the first kStrip = 9 columns.
template <bool kStrips>
__device__ __forceinline__ void store_columns(float* surf, int m0,
                                              const float (&d)[2][4],
                                              int lane) {
  const int row = m0 + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float* col = surf + (8 * n + 2 * t) * kSurfStride + row;
    if (kStrips && 8 * n + 2 * t >= kStrip) continue;
    col[0] = d[n][0];
    col[8] = d[n][2];
    if (kStrips && 8 * n + 2 * t + 1 >= kStrip) continue;
    col[kSurfStride] = d[n][1];
    col[kSurfStride + 8] = d[n][3];
  }
}

// The edge's output from the surface (position pos, pixel p at
// surf[p * kSurfStride + pos]); `offsets` (shared memory): the edge's 16
// ry, then its 16 rx.
template <int kMode>
__device__ __forceinline__ void write_output(float* dst, const float* surf,
                                             const int* offsets, int tid) {
  constexpr int n_out = out_rows(kMode) * kOutW;
  for (int o = tid; o < n_out; o += kThreads) {
    const int r = o / kOutW, j = o - r * kOutW;
    const int p = j >> 4, c = j & 15;
    float v;
    if constexpr (strips(kMode)) {
      // pixel p's strip: S[ry + r, 8 rx + c, p], 0 past the window
      const int y = offsets[p] + r, x = 8 * offsets[kPix + p] + c;
      v = (y < kRows && x < kCols) ? surf[p * kSurfStride + y * kCols + x]
                                   : 0.0f;
    } else if constexpr (kMode == kNoExt) {
      v = surf[c * kSurfStride + 8 * p + r];         // R[8p + r, c]
    } else {                                         // S[r, p, c]
      v = surf[c * kSurfStride + r * kCols + p];
    }
    dst[o] = v;
  }
}

// A run of a block's edges: its positions i = start .. start + len - 1
// (len 0 past the block's last edge).
struct Run {
  int start, len;
};

// Front: __device__ int edges(int E) const, how many edges of the order are
// computed; __device__ size_t edge(int j) const, the j-th edge of the order;
// __device__ const __nv_bfloat16* origin(size_t e) const, the first channel
// of edge e's window position (0, 0); size_t row_stride, the elements
// between two window rows (columns are C apart). Edges that share a window
// share its origin. kGroup: the most edges of one group. With kGroup = 1 a
// block takes every grid-th edge of the order (blocks that run at the same
// time read neighbouring edges' windows), else one contiguous run of the
// order (so that the edges of one window meet in one block). `staged`:
// null, or a counter to which the kernel adds one for each window it stages.
template <typename Front, int kMode, int kGroup>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
window_kernel(const Front front, const __nv_bfloat16* __restrict__ g,
              const int* __restrict__ ry, const int* __restrict__ rx,
              float* __restrict__ out, int E, int depth,
              unsigned long long* __restrict__ staged) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* gs = stages + depth * kStageElems;   // (2, kGroup, 16, kGStride)
  int* offsets = reinterpret_cast<int*>(gs + 2 * kGroup * kGElems);  // (2, kGroup, 32)
  float* surf = reinterpret_cast<float*>(offsets + 2 * kGroup * 2 * kPix);
  constexpr bool kProduct = kMode != kNoMM;
  static_assert(kProduct || kGroup == 1, "window values are read an edge a run");
  constexpr int n_out = out_rows(kMode) * kOutW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long computed = front.edges(E);
  const int b = blockIdx.x, grid = gridDim.x;
  // the block's edges: every grid-th edge of the order, or one contiguous
  // run of it; position i of the block is the order's edge_at(i)
  constexpr bool kStrided = kGroup == 1;
  const int lo = kStrided ? b : static_cast<int>(computed * b / grid);
  const int count =
      kStrided ? (b < computed ? static_cast<int>((computed - 1 - b) / grid) + 1 : 0)
               : static_cast<int>(computed * (b + 1) / grid) - lo;
  if (count <= 0) return;
  auto edge_at = [&](int i) {
    return front.edge(kStrided ? lo + i * grid : lo + i);
  };

  // the run that starts at position i: the next edges of the same window
  auto run_at = [&](int i) {
    Run r{i, i < count ? 1 : 0};
    if constexpr (kGroup > 1) {
      if (i < count) {
        const __nv_bfloat16* o = front.origin(edge_at(i));
        while (r.len < kGroup && i + r.len < count &&
               front.origin(edge_at(i + r.len)) == o)
          ++r.len;
      }
    }
    return r;
  };
  // run r's patch rows into buffer h, a 16-byte piece a thread an edge, and
  // where the mode reads strips its offsets ry, rx (eight pieces an edge)
  auto copy_rows = [&](const Run& r, int h) {
    if constexpr (kProduct) {
      const int row = tid / (kC / 8), piece = tid % (kC / 8);
      for (int q = 0; q < r.len; ++q) {
        const size_t e = edge_at(r.start + q);
        cp_async16(gs + (h * kGroup + q) * kGElems + row * kGStride + piece * 8,
                   g + (e * kPix + row) * kC + piece * 8);
        if (strips(kMode) && tid < 8)
          cp_async16(offsets + (h * kGroup + q) * 2 * kPix + tid * 4,
                     (tid < 4 ? ry : rx) + e * kPix + (tid & 3) * 4);
      }
    }
  };
  // the window copies of the next step (run wr, chunk wk) into stage ws
  Run wr = run_at(0);
  int wk = 0, ws = 0;
  auto copy_chunk = [&]() {
    if constexpr (kMode != kNoDMA) {
      if (wr.len) {
        if (staged != nullptr && wk == 0 && tid == 0) atomicAdd(staged, 1ull);
        const __nv_bfloat16* src = front.origin(edge_at(wr.start)) + wk * kMmaChunk;
        __nv_bfloat16* dst = stages + ws * kStageElems;
        for (int c = tid; c < kPositions * kChunkPieces; c += kThreads) {
          const int pos = c / kChunkPieces, piece = c % kChunkPieces;
          const int r = pos / kCols, col = pos - r * kCols;
          cp_async16_l2_128(dst + c * 8,
                            src + r * front.row_stride + col * kC + piece * 8);
        }
      }
    }
    if (++wk == kChunks) {
      wk = 0;
      wr = run_at(wr.start + wr.len);
    }
    ws = ws + 1 == depth ? 0 : ws + 1;
    cp_async_commit();
  };

  if constexpr (kMode == kNoDMA) {
    // the windows are multiplied but never copied: zero them once
    const int n_words = depth * kStageElems / 8;
    for (int i = tid; i < n_words; i += kThreads)
      reinterpret_cast<uint4*>(stages)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  Run cur = run_at(0);
  Run next = run_at(cur.start + cur.len);
  copy_rows(cur, 0);                       // in the first group of copies
  for (int s = 0; s < depth - 1; ++s) copy_chunk();

  float acc[kGroup][kWarpTiles][2][4] = {};
  for (int s = 0, n = 0;; ++s) {
    const int k = s % kChunks;
    cp_async_wait_pending(depth - 2);   // this thread's copies of step s
    __syncthreads();                    // everyone's; step s - 1 is done
    if (k == 0) copy_rows(next, (n + 1) & 1);   // read from step s + 4 on
    copy_chunk();
    const __nv_bfloat16* win = stages + (s % depth) * kStageElems;
    if constexpr (!kProduct) {
      // window values: out[r, 32k + c] = W[r, 32k + c], out[r, 128 + c] =
      // W[r, c], positions r < 8
      float* dst = out + edge_at(cur.start) * n_out;
      const int r = tid / kMmaChunk, c = tid % kMmaChunk;
      dst[r * kOutW + k * kMmaChunk + c] = __bfloat162float(win[r * kMmaChunk + c]);
      if (k == 0 && tid < 8 * (kOutW - kC)) {
        const int r2 = tid / (kOutW - kC), c2 = tid % (kOutW - kC);
        dst[r2 * kOutW + kC + c2] = __bfloat162float(win[r2 * kMmaChunk + c2]);
      }
    } else {
      // rows m0 + g and m0 + g + 8 of each m-tile, channels 8t .. 8t+7 of
      // the chunk (corr_mma.cuh's order), then every edge's B words
      const int row = lane >> 2, t = lane & 3;
      unsigned a[kWarpTiles][2][4];
#pragma unroll
      for (int j = 0; j < kWarpTiles; ++j) {
        const __nv_bfloat16* p =
            win + ((warp + kWarps * j) * 16 + row) * kMmaChunk + 8 * t;
        row8(p, a[j][0]);
        row8(p + 8 * kMmaChunk, a[j][1]);
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        if (q < cur.len) {
          ChunkB bw;
          bw.load(gs + ((n & 1) * kGroup + q) * kGElems, kGStride, kPix,
                  k * kMmaChunk, lane);
#pragma unroll
          for (int j = 0; j < kWarpTiles; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int m = 0; m < 2; ++m)
                mma_16816(acc[q][j][m], a[j][0][2 * h], a[j][1][2 * h],
                          a[j][0][2 * h + 1], a[j][1][2 * h + 1],
                          bw.w[m][2 * h], bw.w[m][2 * h + 1]);
        }
      }
    }
    if (k == kChunks - 1) {
      if constexpr (kProduct) {
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          if (q < cur.len) {
            if (q > 0) __syncthreads();   // the last edge's output is read
#pragma unroll
            for (int j = 0; j < kWarpTiles; ++j) {
              store_columns<strips(kMode)>(surf, (warp + kWarps * j) * 16,
                                           acc[q][j], lane);
#pragma unroll
              for (int m = 0; m < 2; ++m)
#pragma unroll
                for (int v = 0; v < 4; ++v) acc[q][j][m][v] = 0.0f;
            }
            __syncthreads();              // the surface is whole
            write_output<kMode>(out + edge_at(cur.start + q) * n_out, surf,
                                offsets + ((n & 1) * kGroup + q) * 2 * kPix, tid);
          }
        }
      }
      cur = next;
      if (!cur.len) break;
      next = run_at(cur.start + cur.len);
      ++n;
    }
  }
}

// `grid` persistent blocks (at most one an edge), `depth` stages; `staged`
// as window_kernel's.
template <typename Front, int kMode, int kGroup>
int launch(const Front& front, const void* g, const void* ry, const void* rx,
           void* out, int E, int grid, int depth, cudaStream_t st,
           void* staged = nullptr) {
  if (E == 0) return 0;
  if (depth < 2 || depth > kMaxDepth || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(depth, kGroup);
  const auto kernel = window_kernel<Front, kMode, kGroup>;
  const cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<std::min(grid, E), kThreads, smem, st>>>(
      front, static_cast<const __nv_bfloat16*>(g), static_cast<const int*>(ry),
      static_cast<const int*>(rx), static_cast<float*>(out), E, depth,
      static_cast<unsigned long long*>(staged));
  return static_cast<int>(cudaGetLastError());
}

// Blocks of the kernel one SM of the current device holds at `depth`
// stages, or minus the cudaError_t of the query.
template <typename Front, int kMode, int kGroup>
int blocks_per_sm(int depth) {
  const size_t smem = smem_bytes(depth, kGroup);
  const auto kernel = window_kernel<Front, kMode, kGroup>;
  int blocks = 0;
  cudaError_t err = allow_shared_memory(kernel, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace window_probe
}  // namespace devo
