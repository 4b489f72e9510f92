// What the three correlation kernels of devo_tpu_torch share: the tap-grid
// constants, the coordinate floor, loads of four consecutive channels of a
// feature vector as floats (f32, bf16 or int8 storage), the per-thread dot
// product over the channels, and the launch helper that opts a kernel in to
// more than 48 KB of dynamic shared memory.
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
// (ox, oy), with the fractional parts of the pixel's coordinate.
__device__ __forceinline__ float blend_tap(const float* taps8x8, int ox, int oy,
                                           float x, float y) {
  const float fx = x - floorf(x);
  const float fy = y - floorf(y);
  const float* tp = taps8x8 + oy * kTaps + ox;
  return (1.0f - fx) * (1.0f - fy) * tp[0] + fx * (1.0f - fy) * tp[1] +
         (1.0f - fx) * fy * tp[kTaps] + fx * fy * tp[kTaps + 1];
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

}  // namespace devo
