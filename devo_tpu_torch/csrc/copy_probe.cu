// The copy-issue probe, for Hopper (sm_90a): what issuing a window copy
// from device memory into shared memory costs, stripped of everything else.
// Plain C interface, loaded with ctypes by devo_tpu_torch/ops/probe_cuda.py;
// the plain version is ops/probe.copy_probe.
//
// Replaces the TPU kernels `kernel` and `kernel_ns`
// (scripts/probe_desc_wall.py:110 and :75, pallas_call at :174): n window
// copies of an int8 band ring, a ring of stages with copies in flight, and a
// token touch of each landed window (its first row, summed as f32) so that
// nothing is elided. The modes: "single" (one window of 384 rows x 128
// bytes a copy), "dual" / "quad" (the copies dealt in turn to 2 / 4
// independent rings of stages), "pair" (one copy spans the same rows of two
// consecutive slots), "tallM" (M windows' rows a copy), "local" (the copies
// come from a column of the ring held in shared memory, loaded once). The
// TPU's descriptor + semaphore pair has two counterparts here, and the probe
// runs both:
//   cp.async  every thread copies 16 bytes at a time (cp.async.cg) and waits
//             for its own groups; "local", whose source is shared memory,
//             which cp.async cannot read, copies by 16-byte loads and stores;
//   bulk      one thread issues a 1-D bulk copy (cp.async.bulk, the TMA's
//             unit) per contiguous run and the readers wait on the stage's
//             mbarrier ("pair" takes two, one per slot).
// The ring's depth is fitted to the 227 KB of a block (ops/probe_cuda.
// copy_depth): 4 stages of one window, 2 of a pair or of tall2, 1 of tall4,
// 2 beside the 128 KB column of "local"; tall8 (384 KB a copy) does not fit
// a block and the wrapper refuses it. All stages are in flight at once.
//
// Blocks: the TPU ran one program; here the copies are split into
// contiguous runs, one a block, and each block writes the sum of its run;
// a second kernel adds the blocks' sums in block order. Every value is an
// integer and every sum stays below 2^24, so the result is exact and equal
// to the plain version's in any order.
//
// What bounds it on an H100: the bytes. 9600 copies of 48 KB move 472 MB
// into shared memory at the driver's point; the distinct ring rows they read
// from device memory are about half of that (random windows overlap), 0.07 ms
// at 3.35 TB/s. For "local" only the column comes from device memory.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 256;
constexpr int kC = 128;          // bytes of a row
constexpr int kWR = 16 * 24;     // rows of a window
constexpr int kMaxStages = 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of `bar` with this parity. A copy that never lands
// (a fault of the probe) ends the kernel with an error after about 2^30
// polls, instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  for (unsigned polls = 0; !mbar_try_wait(bar, parity); ++polls)
    if (polls > (1u << 30)) __trap();
}
// device memory -> shared memory, completion counted on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// The address of `p` in the shared memory window of the cluster, for this
// block (rank 0 of a cluster of one)
__device__ __forceinline__ unsigned cluster_addr(const void* p) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(0u));
  return out;
}
// shared memory -> shared memory of the same block: the destination and the
// barrier addressed in the cluster's window, the kernel launched as a
// cluster of one block (launch_cluster)
__device__ __forceinline__ void bulk_copy_local(void* dst, const void* src,
                                                unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(cluster_addr(dst)),
      "r"(smem_addr(src)), "r"(bytes), "r"(cluster_addr(bar))
      : "memory");
}

struct CopyArgs {
  const int8_t* ring;        // (MEM, rows, 128)
  const int* slot;           // (n,)
  const int* row0;           // (n,), multiples of 8
  float* partial;            // (gridDim.x, 128)
  long long slot_bytes;      // rows * 128
  int n, run, S, M, ns, depth, colr;
};

template <bool kBulk, bool kLocal>
__global__ void __launch_bounds__(kThreads) copy_probe_kernel(const CopyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxStages + 1];
  const int tid = threadIdx.x;
  const int first = blockIdx.x * a.run;
  const int count = max(0, min(a.run, a.n - first));
  const int part = a.M * kWR * kC;                 // bytes of one slot's part
  const int stage_bytes = a.S * part;
  const int per_ring = a.depth / a.ns;
  unsigned char* col = smem + a.depth * stage_bytes;   // "local": (colr, 128)

  // copy i of the run goes to ring i % ns, stage (i / ns) % per_ring of it:
  // copy i + depth reuses copy i's stage
  auto stage_of = [&](int i) {
    return (i % a.ns) * per_ring + (i / a.ns) % per_ring;
  };
  auto stage = [&](int i) { return smem + stage_of(i) * stage_bytes; };
  auto source = [&](int i, int s) {
    return reinterpret_cast<const unsigned char*>(a.ring) +
           (static_cast<size_t>(__ldg(a.slot + first + i)) + s) * a.slot_bytes +
           static_cast<size_t>(__ldg(a.row0 + first + i)) * kC;
  };
  auto local_source = [&](int i) {
    return col + (min(__ldg(a.row0 + first + i), a.colr - kWR - 8) & ~7) * kC;
  };
  auto issue = [&](int i) {
    if (i >= count) {
      if (!kBulk) cp_async_commit();       // an empty group keeps the count
      return;
    }
    unsigned char* dst = stage(i);
    if (kBulk) {
      if (tid == 0) {
        uint64_t* bar = &bars[stage_of(i)];
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_expect_tx(bar, stage_bytes);
        if (kLocal) {
          bulk_copy_local(dst, local_source(i), part, bar);
        } else {
          for (int s = 0; s < a.S; ++s) bulk_copy(dst + s * part, source(i, s), part, bar);
        }
      }
      return;
    }
    if (kLocal) {
      const uint4* src = reinterpret_cast<const uint4*>(local_source(i));
      for (int ch = tid; ch < part / 16; ch += kThreads)
        reinterpret_cast<uint4*>(dst)[ch] = src[ch];
    } else {
      for (int s = 0; s < a.S; ++s) {
        const unsigned char* src = source(i, s);
        for (int ch = tid; ch < part / 16; ch += kThreads)
          cp_async16(dst + s * part + ch * 16, src + ch * 16);
      }
    }
    cp_async_commit();
  };

  if (kBulk && tid == 0) {
    for (int s = 0; s <= a.depth; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (kLocal && count > 0) {
    // the column, once: slot 0's first colr rows
    const int bytes = a.colr * kC;
    if (kBulk) {
      if (tid == 0) {
        mbar_expect_tx(&bars[a.depth], bytes);
        bulk_copy(col, a.ring, bytes, &bars[a.depth]);
      }
      mbar_wait(&bars[a.depth], 0);
    } else {
      for (int ch = tid; ch < bytes / 16; ch += kThreads)
        cp_async16(col + ch * 16, reinterpret_cast<const unsigned char*>(a.ring) + ch * 16);
      cp_async_commit();
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  for (int k = 0; k < a.depth; ++k) issue(k);
  float acc = 0.0f;
  for (int i = 0; i < count; ++i) {
    if (kBulk) {
      if (tid < kC) mbar_wait(&bars[stage_of(i)], (i / a.depth) & 1);
    } else {
      cp_async_wait_pending(a.depth - 1);   // this thread's part of copy i
      __syncthreads();
    }
    if (tid < kC) {
      const int8_t* w = reinterpret_cast<const int8_t*>(stage(i));
      acc += static_cast<float>(w[tid]);
      if (a.S == 2) acc += static_cast<float>(w[part + tid]);
    }
    __syncthreads();                        // stage i read before reuse
    issue(i + a.depth);
  }
  if (tid < kC) a.partial[static_cast<size_t>(blockIdx.x) * kC + tid] = acc;
}

// out[c] = the sum of the blocks' sums, in block order
__global__ void copy_probe_sum(const float* partial, int blocks, float* out) {
  const int c = threadIdx.x;
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) s += partial[b * kC + c];
  out[c] = s;
}

template <bool kBulk, bool kLocal>
int launch(const CopyArgs& a, int blocks, float* out, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(a.depth) * a.S * a.M * kWR * kC +
                      (kLocal ? static_cast<size_t>(a.colr) * kC : 0);
  cudaError_t err = allow_shared_memory(copy_probe_kernel<kBulk, kLocal>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kBulk && kLocal) {
    // the copy within shared memory addresses the cluster's window: launch
    // as clusters of one block
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, copy_probe_kernel<kBulk, kLocal>, a);
    if (err == cudaSuccess) err = cudaGetLastError();
  } else {
    copy_probe_kernel<kBulk, kLocal><<<blocks, kThreads, smem, st>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  copy_probe_sum<<<1, kC, 0, st>>>(a.partial, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launches (0 = success). Launches on
// `stream` and does not synchronise. ring (MEM, rows, 128) int8, 16-byte
// aligned, slot_bytes = rows * 128; slot, row0 (n,) int32, row0 multiples of
// 8; partial (blocks, 128) f32 scratch; out (1, 128) f32. S slots, M windows
// a copy, ns rings (a divisor of depth), depth stages (1 .. 4); local = copy
// out of a column of colr rows of slot 0 held in shared memory; bulk = the
// bulk-copy route, else cp.async. The dynamic shared memory taken is that of
// ops/probe_cuda.copy_smem_bytes.
extern "C" int devo_copy_probe(const void* ring, const void* slot,
                               const void* row0, void* partial, void* out,
                               long long slot_bytes, int n, int blocks, int S,
                               int M, int ns, int depth, int local, int colr,
                               int bulk, void* stream) {
  if (blocks < 1 || depth < 1 || depth > kMaxStages || ns < 1 || depth % ns ||
      S < 1 || S > 2 || M < 1 || (local && colr < kWR + 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const CopyArgs a{static_cast<const int8_t*>(ring), static_cast<const int*>(slot),
                   static_cast<const int*>(row0), static_cast<float*>(partial),
                   slot_bytes, n, (n + blocks - 1) / blocks, S, M, ns, depth, colr};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (bulk) return local ? launch<true, true>(a, blocks, o, st) : launch<true, false>(a, blocks, o, st);
  return local ? launch<false, true>(a, blocks, o, st) : launch<false, false>(a, blocks, o, st);
}
