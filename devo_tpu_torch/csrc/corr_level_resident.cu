// Level 4 of the sparse patch correlation, read from a ring slot that is
// resident in shared memory, for Hopper (sm_90a). Plain C interface, loaded
// with ctypes by devo_tpu_torch/ops/corr_cuda.py.
//
// Replaces the TPU kernel `_kernel_l4_resident`
// (devo_tpu/ops/corr_pallas.py:1042, reached through corr_level_l4_resident
// :1088, pallas_call at :1170) and its padded ring layout pad_frame_l4_i8
// (:1027). What the TPU kernel keeps out of device memory is the whole
// level-4 int8 ring, copied once into its fast memory. A block of this card
// has 227 KB of shared memory and one level-4 frame at 480x640 is
// 30 x 40 x 128 int8 = 153,600 bytes: so one ring slot per block is
// resident, and the block walks the edges whose target frame is that slot.
// int8 rings only, as on the TPU.
//
// What it computes is csrc/corr_level.cu's function (ops/corr.corr_level):
// per edge the 8x8 integer-tap dots of gmap[kk[e]] around each pixel's
// floor coordinate in fmap[jj[e]], times the slot's scale, blended to 7x7;
// (E, 49*P*P) f32 in [dx, dy, pixel] order. Out-of-image taps read zero by a
// bounds check, so the frame needs no padded layout.
//
// The launch is a grid (mem, S). The wrapper sorts the edges by slot on the
// device (`order`, with `offsets` (mem + 1,) into it); block (slot, s) copies
// the slot's frame into shared memory with 16-byte loads and its warps take
// the slot's edges in turn, one edge per warp at a time: the warp stages the
// edge's patch feature as f32, each lane takes whole dots over C for its
// share of the 9 x 64 taps (dot_rotated: lanes start at different channels,
// so that vectors C bytes apart fall into different banks), and the blended
// rows go to the edge's own position in `out`. A block whose share of the
// slot is empty returns before it loads the frame.
//
// What bounds it on an H100: bytes (the (E, 441) f32 output and the patch
// features; the ring is read once per block, from L2 after the first), and
// in practice the one block of 8 warps that fits an SM beside a 150 KB
// frame: little latency is hidden. The design trades that for taps that
// never leave the SM.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename G>
__global__ void __launch_bounds__(kThreads)
corr_level_resident_kernel(const G* __restrict__ gmap,
                           const int8_t* __restrict__ fmap,
                           const float* __restrict__ dq,
                           const float* __restrict__ coords,
                           const int* __restrict__ kk,
                           const int* __restrict__ order,
                           const int* __restrict__ offsets,
                           float* __restrict__ out, int PP, int C, int H,
                           int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int frame_bytes = H * W * C;                  // a multiple of 16
  const int8_t* frame = reinterpret_cast<const int8_t*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_taps = PP * kTaps * kTaps;
  float* g = reinterpret_cast<float*>(smem_raw + frame_bytes) +
             warp * (PP * C + n_taps);                // (PP, C), this warp's
  float* taps = g + PP * C;                           // (PP, 8, 8)

  const int slot = blockIdx.x;
  const int end = offsets[slot + 1];
  const int first = offsets[slot] + blockIdx.y * kWarps;
  if (first >= end) return;       // no edge of this slot for this block

  const uint4* src = reinterpret_cast<const uint4*>(
      fmap + static_cast<size_t>(slot) * frame_bytes);
  uint4* dst = reinterpret_cast<uint4*>(smem_raw);
  for (int i = threadIdx.x; i < frame_bytes / 16; i += kThreads) dst[i] = src[i];
  __syncthreads();

  const float q = dq[slot];
  const int start = (kVec * lane) % C;
  const int n_out = kOut * kOut * PP;
  for (int i = first + warp; i < end; i += gridDim.y * kWarps) {
    const int e = order[i];
    const G* gsrc = gmap + static_cast<size_t>(kk[e]) * PP * C;
    for (int c = lane; c < PP * C; c += 32) g[c] = to_float(gsrc[c]);
    __syncwarp();

    const float* ce = coords + static_cast<size_t>(e) * PP * 2;
    for (int it = lane; it < n_taps; it += 32) {
      const int p = it / (kTaps * kTaps);
      const int tap = it - p * kTaps * kTaps;
      const int iy = floor_index(ce[2 * p + 1]) + tap / kTaps - kRadius;
      const int ix = floor_index(ce[2 * p]) + tap % kTaps - kRadius;
      float acc = 0.0f;
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        acc = dot_rotated(g + p * C, frame + (iy * W + ix) * C, C, start);
      taps[it] = acc * q;
    }
    __syncwarp();

    // bilinear blend: out[e][(ox * 7 + oy) * PP + p]
    float* row = out + static_cast<size_t>(e) * n_out;
    for (int o = lane; o < n_out; o += 32) {
      const int p = o % PP;
      const int t = o / PP;
      row[o] = blend_tap(taps + p * kTaps * kTaps, t / kOut, t % kOut,
                         ce[2 * p], ce[2 * p + 1]);
    }
    __syncwarp();                 // before the next edge overwrites g, taps
  }
}

template <typename G>
int launch(const void* gmap, const void* fmap, const void* dq,
           const void* coords, const void* kk, const void* order,
           const void* offsets, void* out, int mem, int S, int PP, int C,
           int H, int W, cudaStream_t st) {
  const size_t smem =
      static_cast<size_t>(H) * W * C +
      static_cast<size_t>(kWarps) * (PP * C + PP * kTaps * kTaps) *
          sizeof(float);
  const cudaError_t err =
      allow_shared_memory(corr_level_resident_kernel<G>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_level_resident_kernel<G><<<dim3(mem, S), kThreads, smem, st>>>(
      static_cast<const G*>(gmap), static_cast<const int8_t*>(fmap),
      static_cast<const float*>(dq), static_cast<const float*>(coords),
      static_cast<const int*>(kk), static_cast<const int*>(order),
      static_cast<const int*>(offsets), static_cast<float*>(out), PP, C, H,
      W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 = success). Launches on `stream`
// and does not synchronise. All pointers are device pointers to contiguous,
// 16-byte aligned tensors: gmap (Mring, P, P, C), bf16 if g_bf16 else f32;
// fmap (mem, H, W, C) int8 with H*W*C a multiple of 16; dq (mem,) f32 slot
// scales; coords (E, P, P, 2) f32 at this level's resolution; kk (E,) int32;
// order (E,) int32, the edges sorted by ring slot; offsets (mem + 1,) int32,
// slot s owning order[offsets[s] : offsets[s + 1]]; out (E, 49*P*P) f32, of
// which every row is written. C is a multiple of 4. The grid is (mem, S).
// The shared memory taken is that of ops/corr_cuda.resident_smem_bytes.
extern "C" int devo_corr_level_resident(const void* gmap, const void* fmap,
                                        const void* dq, const void* coords,
                                        const void* kk, const void* order,
                                        const void* offsets, void* out, int E,
                                        int mem, int S, int PP, int C, int H,
                                        int W, int g_bf16, void* stream) {
  if (E == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g_bf16)
    return launch<__nv_bfloat16>(gmap, fmap, dq, coords, kk, order, offsets,
                                 out, mem, S, PP, C, H, W, st);
  return launch<float>(gmap, fmap, dq, coords, kk, order, offsets, out, mem,
                       S, PP, C, H, W, st);
}
