// What the two window-product probes share (csrc/corr_band_ablate.cu,
// csrc/corr_frame_probe.cu): per edge a window of 16 rows x 24 columns of
// bf16 feature vectors (C = 128) is copied into a ring of stages in shared
// memory, multiplied with the edge's 16 patch rows into the product surface
// R (384 positions x 16, f32), and read out in one of the output layouts of
// ops/probe.py. A front end (the caller's type) says where an edge's window
// rows lie and whether the edge's block is live.
//
// The loop is that of the TPU kernel `_kernel_banded`: a block of 384
// threads (one a window position) walks a run of consecutive edges; the
// copies of edge e+depth-1 (cp.async, 16 bytes a thread) start before the
// products of edge e, one commit group an edge. Three barriers an edge:
//   S1  after the wait for edge e's copies and the store of its patch rows;
//   S2  after the products, before the extraction reads the surface;
//   S3  after the extraction: the next iteration's copies overwrite the
//       stage that products(e) (and, without a product, extraction(e))
//       read, and its products the surface.
// A window position's vector is 16 pieces of 16 bytes; piece k of position
// pos is stored at piece k ^ (pos & 7), so that eight consecutive positions
// read at one channel hit eight different bank groups, while every lane
// reads the patch rows (f32) at one address, a broadcast.
#pragma once

#include "corr_common.cuh"

namespace devo {
namespace window_probe {

constexpr int kC = 128;                    // channels
constexpr int kRows = 16;                  // window rows
constexpr int kCols = 24;                  // window columns
constexpr int kPositions = kRows * kCols;  // 384
constexpr int kPix = 16;                   // patch rows multiplied
constexpr int kStrip = 9;                  // pixels whose strips are read
constexpr int kOutW = 16 * kStrip;         // 144
constexpr int kThreads = kPositions;
constexpr int kPieces = kC * 2 / 16;       // 16-byte pieces of a vector
constexpr int kMaxDepth = 4;
constexpr size_t kStageBytes = static_cast<size_t>(kPositions) * kC * 2;

// the output layouts (ops/probe.py)
enum Mode { kFull = 0, kNoExt = 1, kNoMM = 2, kNoDMA = 3, kSurfaceRows = 4 };

__host__ __device__ constexpr int out_rows(int mode) {
  return mode == kSurfaceRows ? kRows : 8;
}

inline size_t smem_bytes(int depth) {
  return depth * kStageBytes + (kPix * kC + kPositions * kPix) * sizeof(float);
}

// Front: __device__ const __nv_bfloat16* row(int e, int r) const, the first
// of window row r's 24 vectors of edge e; __device__ bool live(int first)
// const, whether the block whose run starts at edge `first` computes.
template <typename Front, int kMode>
__global__ void __launch_bounds__(kThreads)
window_kernel(const Front front, const __nv_bfloat16* __restrict__ g,
              const int* __restrict__ ry, const int* __restrict__ rx,
              float* __restrict__ out, int E, int run, int depth) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* stages = smem_raw;                             // (depth, 384, C) bf16
  float* gs = reinterpret_cast<float*>(stages + depth * kStageBytes);  // (16, C)
  float* surface = gs + kPix * kC;                              // (384, 16)
  const int tid = threadIdx.x;
  const int first = blockIdx.x * run;
  if (first >= E || !front.live(first)) return;   // the whole block
  const int count = min(run, E - first);
  constexpr int n_out = out_rows(kMode) * kOutW;

  auto stage = [&](int n) { return stages + (n % depth) * kStageBytes; };
  auto start_copies = [&](int n) {
    if (kMode == kNoDMA) return;
    unsigned char* dst = stage(n);
    constexpr int per_row = kCols * kPieces;
    for (int i = tid; i < kRows * per_row; i += kThreads) {
      const int r = i / per_row;
      const int rem = i - r * per_row;
      const int col = rem / kPieces, k = rem - col * kPieces;
      const int pos = r * kCols + col;
      cp_async16(dst + (pos * kPieces + (k ^ (pos & 7))) * 16,
                 front.row(first + n, r) + col * kC + k * 8);
    }
  };

  if (kMode == kNoDMA) {
    // the windows are read but never copied: zero them once
    const int n_words = static_cast<int>(depth * kStageBytes / 16);
    for (int i = tid; i < n_words; i += kThreads)
      reinterpret_cast<uint4*>(stages)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  for (int n = 0; n < depth - 1; ++n) {
    if (n < count) start_copies(n);
    cp_async_commit();
  }

  for (int e = 0; e < count; ++e) {
    const size_t edge = static_cast<size_t>(first) + e;
    if (e + depth - 1 < count) start_copies(e + depth - 1);
    cp_async_commit();              // a group every iteration, empty at the end
    if (kMode != kNoMM) {
      // the patch rows as f32, 8 channels a thread
      const __nv_bfloat16* ge = g + edge * kPix * kC;
      for (int i = tid * 8; i < kPix * kC; i += kThreads * 8) {
        float v[8];
        load_piece(ge + i, v);
        *reinterpret_cast<float4*>(gs + i) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(gs + i + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    cp_async_wait_pending(depth - 1);     // this thread's copies of edge e
    __syncthreads();                      // S1
    const unsigned char* win = stage(e);
    if (kMode != kNoMM) {
      const int pos = tid;
      float acc[kPix];
#pragma unroll
      for (int p = 0; p < kPix; ++p) acc[p] = 0.0f;
      const unsigned char* vec = win + pos * kPieces * 16;
      for (int k = 0; k < kPieces; ++k) {
        float v[8];
        load_piece(reinterpret_cast<const __nv_bfloat16*>(vec + (k ^ (pos & 7)) * 16), v);
#pragma unroll
        for (int p = 0; p < kPix; ++p) {
          const float4 g0 = *reinterpret_cast<const float4*>(gs + p * kC + k * 8);
          const float4 g1 = *reinterpret_cast<const float4*>(gs + p * kC + k * 8 + 4);
          acc[p] = fmaf(g0.x, v[0], acc[p]);
          acc[p] = fmaf(g0.y, v[1], acc[p]);
          acc[p] = fmaf(g0.z, v[2], acc[p]);
          acc[p] = fmaf(g0.w, v[3], acc[p]);
          acc[p] = fmaf(g1.x, v[4], acc[p]);
          acc[p] = fmaf(g1.y, v[5], acc[p]);
          acc[p] = fmaf(g1.z, v[6], acc[p]);
          acc[p] = fmaf(g1.w, v[7], acc[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kPix; p += 4)
        *reinterpret_cast<float4*>(surface + pos * kPix + p) =
            make_float4(acc[p], acc[p + 1], acc[p + 2], acc[p + 3]);
      __syncthreads();                    // S2
    }

    float* dst = out + edge * n_out;
    const int* rye = ry + edge * kPix;
    const int* rxe = rx + edge * kPix;
    for (int o = tid; o < n_out; o += kThreads) {
      const int r = o / kOutW, j = o - r * kOutW;
      const int p = j >> 4, c = j & 15;
      float v;
      if (kMode == kFull || kMode == kNoDMA) {
        const int y = __ldg(rye + p) + r, x = 8 * __ldg(rxe + p) + c;
        v = (y < kRows && x < kCols) ? surface[(y * kCols + x) * kPix + p] : 0.0f;
      } else if (kMode == kNoExt) {
        v = surface[(8 * p + r) * kPix + c];
      } else if (kMode == kSurfaceRows) {
        v = surface[(r * kCols + p) * kPix + c];
      } else {                            // kNoMM: window position r
        const int ch = j < kC ? j : j - kC;
        const unsigned char* vec = win + r * kPieces * 16;
        v = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(
            vec + ((ch >> 3) ^ (r & 7)) * 16)[ch & 7]);
      }
      dst[o] = v;
    }
    __syncthreads();                      // S3
  }
}

template <typename Front, int kMode>
int launch(const Front& front, const void* g, const void* ry, const void* rx,
           void* out, int E, int run, int depth, cudaStream_t st) {
  if (E == 0) return 0;
  if (depth < 2 || depth > kMaxDepth || run < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(depth);
  const cudaError_t err = allow_shared_memory(window_kernel<Front, kMode>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (E + run - 1) / run;
  window_kernel<Front, kMode><<<grid, kThreads, smem, st>>>(
      front, static_cast<const __nv_bfloat16*>(g), static_cast<const int*>(ry),
      static_cast<const int*>(rx), static_cast<float*>(out), E, run, depth);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace window_probe
}  // namespace devo
