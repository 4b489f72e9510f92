// The window product on the tensor cores, for the correlation kernels that
// stage windows of feature vectors in shared memory (csrc/corr.cu,
// csrc/corr_fixed.cu).
//
// What it computes: the surface s[pos][p] = <window[pos], g[p]> of a staged
// window (positions x channels, bf16 or int8) against the patch's pixel
// features g (pixels x channels, bf16), in f32, by
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: A is 16 window
// positions x 16 channels, B 16 channels x 8 pixels (two n-tiles hold up to
// 16 pixels; columns past the patch's pixels are zero registers), and the
// accumulators go to a surface of f32 in shared memory as (positions,
// pixels). bf16 x bf16 products are exact in f32, and every int8 value is
// exact in bf16 (|v| <= 128 needs 8 significant bits), so only the order of
// the sums differs from a dot on the CUDA cores.
//
// The fragments are loaded by hand, in a channel order of our own: the dot
// runs over all channels, so any permutation of them that A and B share
// gives the same sums. Of a chunk of 32 channels, lane (g = lane / 4,
// t = lane % 4) holds channels 8t .. 8t+7 of A's rows g and g+8 and of B's
// pixel g: one 16-byte read a row for bf16, one 8-byte read for int8. The
// mma's logical k = {2t, 2t+1, 2t+8, 2t+9} of k-step s is then channel
// 8t + 4s + {0, 1, 2, 3}. A row of a staged window starts an odd multiple of
// 32 channels after the last (`mma_stride`), so that the lanes of one
// shared-memory phase (8 lanes of 16 bytes, or 16 lanes of 8 bytes) read
// distinct banks. The int8 -> bf16 conversion happens in these loads, once
// per staged byte and edge: each m-tile is read by one warp, and both
// n-tiles share its A registers.
//
// Zero padding, which every operand needs where the product would read past
// its data: channels C .. Ck of a window row and of a pixel (Ck = C rounded
// up to 32, a whole number of chunks), window rows past the last position up
// to a multiple of 16, and positions off the image. All of them are written
// as zeros by the staging copies themselves (cp.async with a source size of
// 0), so no fragment reads shared memory that was not written.
//
// What bounds it: not the products (a 3x3 patch against a 10x10 window at
// C = 128 is 7 m-tiles x 2 n-tiles x 8 k-steps = 112 mma.sync an edge and
// level) but the bytes that reach shared memory and the reads of A from it.
//
// Users: the edge pipeline of csrc/corr_pipe.cuh (csrc/corr.cu,
// corr_pair.cu, corr_pair2.cu, corr_mono2.cu, corr_mono3.cu, corr_group.cu,
// corr_group8.cu, corr_level_pipe.cu, corr_level_full.cu, corr_level.cu:
// covering windows, bf16 and int8 rings), csrc/corr_fixed.cu (the fixed
// 16x24 window, bf16 rings), csrc/corr_level_resident.cu (windows read
// in place from a swizzled int8 frame, tile_chunk_rows) and the probes'
// csrc/window_probe.cuh (csrc/corr_band_ablate.cu, corr_frame_probe.cu:
// the fixed 16x24 window of bf16 vectors against 16 patch rows, staged in
// chunks of 32 channels).
#pragma once

#include "corr_common.cuh"

namespace devo {

constexpr int kMmaChunk = 32;   // channels of a chunk: two k-steps

// Channels a staged row holds: C rounded up to whole chunks.
__host__ __device__ constexpr int mma_channels(int C) {
  return (C + kMmaChunk - 1) / kMmaChunk * kMmaChunk;
}

// Elements between two rows of an operand staged for the mma: the row's
// chunks, and one chunk more where their number is even, so that rows lie
// an odd number of chunks apart (the bank rule above).
__host__ __device__ constexpr int mma_stride(int C) {
  return mma_channels(C) / kMmaChunk % 2 ? mma_channels(C)
                                         : mma_channels(C) + kMmaChunk;
}

// The largest copy (16, 8 or 4 bytes) that a feature vector of `bytes` is a
// whole number of.
__host__ __device__ constexpr int copy_bytes(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : 4;
}

// A copy of CB bytes from device to shared memory, or CB zero bytes where
// `valid` is false (the source is then not read; `src` is any mapped
// address).
template <int CB>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? CB : 0;
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(CB), "r"(n)
                 : "memory");
}

// Start the copies of `rows` rows of `chans` elements (a multiple of the
// copy) to dst (`stride` elements apart): row r takes elements 0 .. C-1 from
// src(r) where src(r) is not null, zeros elsewhere. `any` is a device
// address that a zero copy names as its source (it reads nothing). By the
// threads tid = 0 .. nthreads - 1; the caller commits the group.
template <int CB, typename T, typename Src>
__device__ __forceinline__ void stage_rows(T* dst, int stride, int rows,
                                           int chans, int C, Src src,
                                           const T* any, int tid,
                                           int nthreads) {
  constexpr int kEl = CB / static_cast<int>(sizeof(T));
  const int per_row = chans / kEl;
  for (int i = tid; i < rows * per_row; i += nthreads) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * kEl;
    const T* s = src(r);
    const bool valid = s != nullptr && c < C;
    cp_async_zfill<CB>(dst + static_cast<size_t>(r) * stride + c,
                       valid ? s + c : any, valid);
  }
}

// The same for the copy size that fits a vector of C elements of T.
template <typename T, typename Src>
__device__ __forceinline__ void stage_rows_any(T* dst, int stride, int rows,
                                               int chans, int C, Src src,
                                               const T* any, int tid,
                                               int nthreads) {
  switch (copy_bytes(C * static_cast<int>(sizeof(T)))) {
    case 16: stage_rows<16>(dst, stride, rows, chans, C, src, any, tid, nthreads); break;
    case 8: stage_rows<8>(dst, stride, rows, chans, C, src, any, tid, nthreads); break;
    default: stage_rows<4>(dst, stride, rows, chans, C, src, any, tid, nthreads); break;
  }
}

// Eight consecutive channels of a row as four bf16x2 words.
__device__ __forceinline__ void row8(const __nv_bfloat16* p, unsigned (&w)[4]) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

// int8 -> bf16, exactly: each byte through the f32 trick of load4 (int8),
// then the upper halves of two such floats, which hold all their bits,
// packed into one word.
__device__ __forceinline__ unsigned i8x2_bf16x2(unsigned u, int k) {
  constexpr float kBias = 8388608.0f + 128.0f;
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + k)) - kBias;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651 + k)) - kBias;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
__device__ __forceinline__ void row8(const int8_t* p, unsigned (&w)[4]) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const unsigned a = v.x ^ 0x80808080u, b = v.y ^ 0x80808080u;
  w[0] = i8x2_bf16x2(a, 0); w[1] = i8x2_bf16x2(a, 2);
  w[2] = i8x2_bf16x2(b, 0); w[3] = i8x2_bf16x2(b, 2);
}

// D += A B for one 16x8x16 step.
__device__ __forceinline__ void mma_16816(float (&d)[4], unsigned a0,
                                          unsigned a1, unsigned a2,
                                          unsigned a3, unsigned b0,
                                          unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The B words of one chunk: pixel g and pixel 8 + g of the patch (zero past
// its PP pixels), channels 8t .. 8t+7 of the chunk at `c0`.
struct ChunkB {
  unsigned w[2][4];
  __device__ __forceinline__ void load(const __nv_bfloat16* g, int gstride,
                                       int PP, int c0, int lane) {
    const int row = lane >> 2, t = lane & 3;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int p = 8 * n + row;
      if (p < PP) {
        row8(g + static_cast<size_t>(p) * gstride + c0 + 8 * t, w[n]);
      } else {
        w[n][0] = w[n][1] = w[n][2] = w[n][3] = 0u;
      }
    }
  }
  // The same from rows of C channels (a multiple of 8), zero past C: the
  // patch feature read where it lies in device memory, its rows not padded
  // to whole chunks.
  __device__ __forceinline__ void load_upto(const __nv_bfloat16* g, int C,
                                            int PP, int c0, int lane) {
    const int row = lane >> 2, c = c0 + 8 * (lane & 3);
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int p = 8 * n + row;
      if (p < PP && c < C) {
        row8(g + static_cast<size_t>(p) * C + c, w[n]);
      } else {
        w[n][0] = w[n][1] = w[n][2] = w[n][3] = 0u;
      }
    }
  }
};

// One chunk of an m-tile: rows m0 + g and m0 + g + 8 of the window `win`
// (`stride` elements apart), channels c0 .. c0+31, into both n-tiles'
// accumulators d[0], d[1].
template <typename F>
__device__ __forceinline__ void tile_chunk(float (&d)[2][4], const F* win,
                                           int stride, int m0, int c0,
                                           const ChunkB& b, int lane) {
  const int row = lane >> 2, t = lane & 3;
  unsigned ra[4], rb[4];
  const F* p = win + static_cast<size_t>(m0 + row) * stride + c0 + 8 * t;
  row8(p, ra);
  row8(p + static_cast<size_t>(8) * stride, rb);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      mma_16816(d[n], ra[2 * s], rb[2 * s], ra[2 * s + 1], rb[2 * s + 1],
                b.w[n][2 * s], b.w[n][2 * s + 1]);
}

// Rows of int8 stored in swizzled 16-byte chunks (csrc/corr_level_resident.cu's
// resident frame): chunk k of a row lies at chunk k ^ sw, sw the row's own
// swizzle. The address of channels c .. c+7 (c a multiple of 8) of a row.
__device__ __forceinline__ const int8_t* swizzled_at(const int8_t* row, int sw,
                                                     int c) {
  return row + (((c >> 4) ^ sw) << 4) + (c & 15);
}

// One chunk of an m-tile whose rows lie anywhere, as tile_chunk: row m0 + g
// at `ra` with swizzle `sa`, row m0 + g + 8 at `rb` with `sb` (each lane's
// own two rows), channels c0 .. c0+31 (rows padded to whole chunks).
__device__ __forceinline__ void tile_chunk_rows(float (&d)[2][4],
                                                const int8_t* ra, int sa,
                                                const int8_t* rb, int sb,
                                                int c0, const ChunkB& b,
                                                int lane) {
  const int c = c0 + 8 * (lane & 3);
  unsigned wa[4], wb[4];
  row8(swizzled_at(ra, sa, c), wa);
  row8(swizzled_at(rb, sb, c), wb);
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      mma_16816(d[n], wa[2 * s], wb[2 * s], wa[2 * s + 1], wb[2 * s + 1],
                b.w[n][2 * s], b.w[n][2 * s + 1]);
}

// The accumulators of an m-tile, times `scale`, into the surface (row pos at
// surf + pos * ss, a column per pixel, ss even): rows m0 + g, m0 + g + 8,
// columns 8n + 2t and 8n + 2t + 1 where they are pixels of the patch. With
// kRound each sum is rounded once to bf16 (nearest even) before the scale.
template <bool kRound = false>
__device__ __forceinline__ void store_tile(float* surf, int ss, int m0,
                                           const float (&d)[2][4], int PP,
                                           float scale, int lane) {
  const int row = lane >> 2, t = lane & 3;
  auto tap = [&](float sum) {
    if constexpr (kRound)
      return __bfloat162float(__float2bfloat16_rn(sum)) * scale;
    else
      return sum * scale;
  };
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int col = 8 * n + 2 * t;
    if (col < PP) {
      *reinterpret_cast<float2*>(surf + (m0 + row) * ss + col) =
          make_float2(tap(d[n][0]), tap(d[n][1]));
      *reinterpret_cast<float2*>(surf + (m0 + row + 8) * ss + col) =
          make_float2(tap(d[n][2]), tap(d[n][3]));
    }
  }
}

// A surface row's length: the patch's pixels, rounded up to even so that a
// lane stores its two columns at once.
__host__ __device__ constexpr int surface_stride(int PP) { return PP + (PP & 1); }

// <g, f> over C channels by one thread, g and f of any element type (f32,
// bf16 or int8), both aligned to four elements: the taps that do not come
// from a staged window.
template <typename G, typename F>
__device__ __forceinline__ float dot_any(const G* g, const F* f, int C) {
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 8
  for (int c = 0; c < C; c += kVec) {
    float gv[kVec], fv[kVec];
    load4(g + c, gv);
    load4(f + c, fv);
    a0 = fmaf(gv[0], fv[0], a0);
    a1 = fmaf(gv[1], fv[1], a1);
    a2 = fmaf(gv[2], fv[2], a2);
    a3 = fmaf(gv[3], fv[3], a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// The bilinear blend of four taps: s at (0, 0), `dx` elements to the right,
// `dy` elements down.
__device__ __forceinline__ float blend_at(const float* s, int dx, int dy,
                                          float fx, float fy) {
  return (1.0f - fx) * (1.0f - fy) * s[0] + fx * (1.0f - fy) * s[dx] +
         (1.0f - fx) * fy * s[dy] + fx * fy * s[dx + dy];
}

}  // namespace devo
