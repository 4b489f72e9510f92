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
// The schedule (K14''): the copies are walked in slot-major order. A first
// kernel, one cluster of 8 blocks, sorts them stably by slot (a pair's
// first slot) into an (n,) scratch, `order` (copy_order_kernel: a counting
// sort); with G blocks, block b then makes the copies at positions b,
// b + G, b + 2G, ... of that order, so that the blocks that run at once
// copy neighbouring windows of one or two slots and the rows those windows
// share come from L2. A block fetches the indices of its next copy before
// it waits for the current one. Each block writes the sum of its copies; a
// last kernel adds the blocks' sums in a fixed order. The second and third
// kernels are launched while the one before them runs (programmatic
// dependent launch). "local" copies out of shared memory and walks the
// copies in their own order, with no sort. Every value is an integer and
// every sum stays below 2^24, so the result is exact and equal to the plain
// version's in any order.
//
// What bounds it on an H100: the bytes. 9600 copies of 48 KB move 472 MB
// into shared memory at the driver's point, drawn from 236 MB of distinct
// ring rows (random windows overlap), 0.0706 ms at 3.35 TB/s. Walked in
// the driver's random order (K14'), the 528 windows in flight (132 blocks
// x 4 stages, 25 MB) spread over all 32 slots, so that windows which share
// rows are almost never in flight together and nearly every window comes
// from device memory again (a model of L2 as an LRU of 128-byte lines puts
// the reads at 400-434 MB). In slot-major order the windows in flight
// cover about two slots (about 300 copies, 9.3 MB of rows a slot), and the
// same model reads each distinct row once: what is left is the 472 MB from
// L2 into shared memory (by bulk copies faster than by cp.async's 16 bytes
// a thread) and the order's kernel ahead of the copies. For "local" only
// the column comes from device memory.

#include "corr_common.cuh"

namespace {

using namespace devo;

constexpr int kThreads = 256;
constexpr int kC = 128;          // bytes of a row
constexpr int kWR = 16 * 24;     // rows of a window
constexpr int kMaxStages = 4;
constexpr int kOrderThreads = 1024;  // a block of the order
constexpr int kOrderBlocks = 8;      // the order's blocks: one cluster
constexpr int kOrderMaxMem = 128;    // slots it counts
constexpr int kOrderBatch = 16;      // tiles a warp of the order holds at once
constexpr int kSumGroups = 8;        // groups of blocks the sum adds apart

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
// The address of `p` in the shared memory window of the cluster, in block
// `rank` of it (0: this block, in a cluster of one)
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank = 0) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(smem_addr(p)), "r"(rank));
  return out;
}
// shared memory -> shared memory of the same block: the destination and the
// barrier addressed in the cluster's window, the kernel launched as a
// cluster of one block (launch_pdl's `cluster`)
__device__ __forceinline__ void bulk_copy_local(void* dst, const void* src,
                                                unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(cluster_addr(dst)),
      "r"(smem_addr(src)), "r"(bytes), "r"(cluster_addr(bar))
      : "memory");
}

// Programmatic dependent launch: the three kernels of a call run in one
// stream, and each of the last two is launched while the one before it
// runs (launch_pdl), so that its blocks take their SMs and set up; it waits
// for that kernel's results (wait_prerequisite) before it reads them. A
// kernel that is launched otherwise passes both at once.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisite() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The cluster's barrier, split: arrive after this thread's last read of
// another block's shared memory, wait before this block's shared memory
// may go
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// *p in the shared memory of block `rank` of this cluster
__device__ __forceinline__ int ld_cluster(const int* p, unsigned rank) {
  int v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"(cluster_addr(p, rank))
               : "memory");
  return v;
}

// order[p] = the copy at position p when the n copies are stably sorted by
// slot (a key outside [0, mem) counts as mem - 1). One cluster of
// kOrderBlocks blocks of 32 warps, a counting sort over tiles of 32
// consecutive copies: block r takes the r-th of kOrderBlocks contiguous
// runs of tiles, warp w of it the w-th of 32 runs of those. In a tile, the
// lanes that hold one slot find each other by ballots, one a bit of the
// slot, and a lane's rank among them is the number of lower lanes. Pass 1
// counts each warp's copies by slot, the group's lowest lane adding the
// group. Then the counts become offsets in slot-major order, then block,
// warp and rank: each block scans its warps' counts slot by slot, reads
// the blocks' totals from their shared memory and scans them. Pass 2 puts
// each copy at its place, and the group's lowest lane moves the warp's
// count on. Stable by construction. A warp holds the keys and groups of
// kOrderBatch tiles in registers (all of its tiles up to n = 32
// kOrderBatch tiles a warp, 131,072 copies), so pass 2 finds them there.
__global__ void __cluster_dims__(kOrderBlocks, 1, 1) __launch_bounds__(kOrderThreads)
copy_order_kernel(const int* slot, int* order, int n, int mem) {
  constexpr int kWarps = kOrderThreads / 32;
  static_assert(kWarps == 32 && kOrderMaxMem * kOrderBlocks <= kOrderThreads,
                "a warp scans a slot's warps, a thread a slot's block total");
  // the count of warp w's copies of slot s, padded so that distinct slots
  // of one warp fall on distinct banks
  __shared__ int cnt[kOrderMaxMem * (kWarps + 1)];
  __shared__ int total[kOrderMaxMem];              // this block's copies of slot s
  __shared__ int base[kOrderMaxMem];               // where they go
  __shared__ int warp_total[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const unsigned rank = blockIdx.x;                // the grid is one cluster
  launch_dependents();
  const unsigned lower = (1u << lane) - 1;
  const int bits = mem > 1 ? 32 - __clz(mem - 1) : 0;          // of a key
  const int all = (n + 31) / 32;                                // tiles
  const int per_block = (all + kOrderBlocks - 1) / kOrderBlocks;
  const int per_warp = (per_block + kWarps - 1) / kWarps;
  const int block_end = min(all, static_cast<int>(rank + 1) * per_block);
  const int tile0 = static_cast<int>(rank) * per_block + warp * per_warp;
  const int tiles = max(0, min(per_warp, block_end - tile0));  // this warp's
  auto count = [&](int s, int w) { return &cnt[s * (kWarps + 1) + w]; };
  auto warp_scan = [&](int v) {                    // inclusive, over the lanes
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, d);
      if (lane >= d) v += u;
    }
    return v;
  };
  // copy i of tile j0 + j of this warp (n past the warp's tiles), its key
  // and the lanes of its tile that hold copies of that key
  int key[kOrderBatch];
  unsigned peers[kOrderBatch];
  auto copy = [&](int j0, int j) {
    return j0 + j < tiles ? min(n, (tile0 + j0 + j) * 32 + lane) : n;
  };
  auto load = [&](int j0) {
#pragma unroll
    for (int j = 0; j < kOrderBatch; ++j) {
      const int i = copy(j0, j);
      key[j] = i < n ? min(max(__ldg(slot + i), 0), mem - 1) : 0;
    }
#pragma unroll
    for (int j = 0; j < kOrderBatch; ++j) {
      if (j0 + j >= tiles) break;                  // the same in every lane
      unsigned m = __ballot_sync(0xffffffffu, copy(j0, j) < n);
      for (int b = 0; b < bits; ++b) {
        const unsigned one = __ballot_sync(0xffffffffu, (key[j] >> b) & 1);
        m &= (key[j] >> b) & 1 ? one : ~one;
      }
      peers[j] = m;
    }
  };
  for (int e = t; e < mem * (kWarps + 1); e += kOrderThreads) cnt[e] = 0;
  __syncthreads();
  for (int j0 = 0; j0 < tiles; j0 += kOrderBatch) {
    load(j0);
#pragma unroll
    for (int j = 0; j < kOrderBatch; ++j)
      if (copy(j0, j) < n && !(peers[j] & lower)) *count(key[j], warp) += __popc(peers[j]);
  }
  __syncthreads();
  // slot s's warp counts -> offsets within this block's copies of s (warp
  // s % 32 scans row s), and the block's total of s
  for (int s = warp; s < mem; s += kWarps) {
    const int x = *count(s, lane);
    const int incl = warp_scan(x);
    *count(s, lane) = incl - x;
    if (lane == 31) total[s] = incl;
  }
  cluster_arrive();
  cluster_wait();                                  // every block's totals are in
  // entry e = s * kOrderBlocks + r', block r''s total of slot s, one a
  // thread; its exclusive sum in that order is where block r' puts slot s
  const int e = t;
  const int x = e < mem * kOrderBlocks
                    ? ld_cluster(&total[e / kOrderBlocks], e % kOrderBlocks) : 0;
  cluster_arrive();                                // done with the others' memory
  const int incl = warp_scan(x);
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int y = warp_total[lane];
    warp_total[lane] = warp_scan(y) - y;
  }
  __syncthreads();
  if (e < mem * kOrderBlocks && e % kOrderBlocks == static_cast<int>(rank))
    base[e / kOrderBlocks] = warp_total[warp] + incl - x;
  __syncthreads();
  for (int j0 = 0; j0 < tiles; j0 += kOrderBatch) {
    if (tiles > kOrderBatch) load(j0);             // else still held
#pragma unroll
    for (int j = 0; j < kOrderBatch; ++j) {
      if (j0 + j >= tiles) break;
      const int i = copy(j0, j);
      int* at = count(key[j], warp);
      if (i < n) order[base[key[j]] + *at + __popc(peers[j] & lower)] = i;
      __syncwarp();
      if (i < n && !(peers[j] & lower)) *at += __popc(peers[j]);
      __syncwarp();
    }
  }
  cluster_wait();                                  // the others are done with ours
}

struct CopyArgs {
  const int8_t* ring;        // (MEM, rows, 128)
  const int* slot;           // (n,)
  const int* row0;           // (n,), multiples of 8
  const int* order;          // (n,) the copies by slot, or null: their own order
  float* partial;            // (gridDim.x, 128)
  long long slot_bytes;      // rows * 128
  int n, S, M, ns, depth, colr;
};

template <bool kBulk, bool kLocal>
__global__ void __launch_bounds__(kThreads) copy_probe_kernel(const CopyArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxStages + 1];
  const int tid = threadIdx.x;
  const int part = a.M * kWR * kC;                 // bytes of one slot's part
  const int stage_bytes = a.S * part;
  const int per_ring = a.depth / a.ns;
  unsigned char* col = smem + a.depth * stage_bytes;   // "local": (colr, 128)

  // copy i of this block is the one at position blockIdx.x + i * gridDim.x
  // of the order; it is made where that position is below n
  auto position = [&](int i) {
    return static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x);
  };
  // the indices of copy i, where it is made, by the threads that issue it
  struct Src { int slot, row0; };
  auto fetch = [&](int i) {
    Src src{0, 0};
    const int p = position(i);
    if (p < a.n && (!kBulk || tid == 0)) {
      const int c = a.order ? __ldg(a.order + p) : p;
      src = {__ldg(a.slot + c), __ldg(a.row0 + c)};
    }
    return src;
  };
  // copy i of the block goes to ring i % ns, stage (i / ns) % per_ring of
  // it: copy i + depth reuses copy i's stage
  auto stage_of = [&](int i) {
    return (i % a.ns) * per_ring + (i / a.ns) % per_ring;
  };
  auto stage = [&](int i) { return smem + stage_of(i) * stage_bytes; };
  auto source = [&](Src src, int s) {
    return reinterpret_cast<const unsigned char*>(a.ring) +
           (static_cast<size_t>(src.slot) + s) * a.slot_bytes +
           static_cast<size_t>(src.row0) * kC;
  };
  auto local_source = [&](Src src) {
    return col + (min(src.row0, a.colr - kWR - 8) & ~7) * kC;
  };
  auto issue = [&](int i, Src src) {
    if (position(i) >= a.n) {
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
          bulk_copy_local(dst, local_source(src), part, bar);
        } else {
          for (int s = 0; s < a.S; ++s) bulk_copy(dst + s * part, source(src, s), part, bar);
        }
      }
      return;
    }
    if (kLocal) {
      const uint4* from = reinterpret_cast<const uint4*>(local_source(src));
      for (int ch = tid; ch < part / 16; ch += kThreads)
        reinterpret_cast<uint4*>(dst)[ch] = from[ch];
    } else {
      for (int s = 0; s < a.S; ++s) {
        const unsigned char* from = source(src, s);
        for (int ch = tid; ch < part / 16; ch += kThreads)
          cp_async16(dst + s * part + ch * 16, from + ch * 16);
      }
    }
    cp_async_commit();
  };

  launch_dependents();
  if (kBulk && tid == 0) {
    for (int s = 0; s <= a.depth; ++s) mbar_init(&bars[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  wait_prerequisite();                       // the order is written
  __syncthreads();
  if (kLocal && position(0) < a.n) {
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

  for (int k = 0; k < a.depth; ++k) issue(k, fetch(k));
  float acc = 0.0f;
  for (int i = 0; position(i) < a.n; ++i) {
    const Src next = fetch(i + a.depth);    // its loads fly during the wait
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
    issue(i + a.depth, next);
  }
  if (tid < kC) a.partial[static_cast<size_t>(blockIdx.x) * kC + tid] = acc;
}

// out[c] = the sum of the blocks' sums: group g of kSumGroups adds blocks
// g, g + kSumGroups, ..., then the groups' sums are added in group order.
__global__ void __launch_bounds__(kSumGroups * kC)
copy_probe_sum(const float* partial, int blocks, float* out) {
  __shared__ float group[kSumGroups][kC];
  const int c = threadIdx.x % kC, g = threadIdx.x / kC;
  wait_prerequisite();                       // the blocks' sums are written
  float s = 0.0f;
  for (int b = g; b < blocks; b += kSumGroups) s += partial[b * kC + c];
  group[g][c] = s;
  __syncthreads();
  if (g == 0) {
    for (int k = 1; k < kSumGroups; ++k) s += group[k][c];
    out[c] = s;
  }
}

int launch_order(const int* slot, int* order, int n, int mem, cudaStream_t st) {
  copy_order_kernel<<<kOrderBlocks, kOrderThreads, 0, st>>>(slot, order, n, mem);
  return static_cast<int>(cudaGetLastError());
}

// `kernel` on `blocks` blocks of `threads`, launched while the kernel before
// it in the stream runs (programmatic dependent launch); `cluster`: as
// clusters of one block
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), int blocks, int threads,
                       size_t smem, cudaStream_t st, bool cluster, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster ? 2 : 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool kBulk, bool kLocal>
int launch(const CopyArgs& a, int blocks, float* out, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(a.depth) * a.S * a.M * kWR * kC +
                      (kLocal ? static_cast<size_t>(a.colr) * kC : 0);
  cudaError_t err = allow_shared_memory(copy_probe_kernel<kBulk, kLocal>, smem);
  // the copy within shared memory ("local", bulk) addresses the cluster's
  // window: launch as clusters of one block
  if (err == cudaSuccess)
    err = launch_pdl(copy_probe_kernel<kBulk, kLocal>, blocks, kThreads, smem, st,
                     kBulk && kLocal, a);
  if (err == cudaSuccess)
    err = launch_pdl(copy_probe_sum, 1, kSumGroups * kC, 0, st, false,
                     static_cast<const float*>(a.partial), blocks, out);
  return static_cast<int>(err);
}

}  // namespace

// The copies' order alone, as devo_copy_probe sorts them: order (n,) int32
// scratch, slot (n,) int32 in [0, mem), mem at most kOrderMaxMem. Returns the
// cudaError_t of the launch (0 = success); launches on `stream` and does not
// synchronise.
extern "C" int devo_copy_order(const void* slot, void* order, int n, int mem,
                               void* stream) {
  if (n < 0 || mem < 1 || mem > kOrderMaxMem)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_order(static_cast<const int*>(slot), static_cast<int*>(order), n,
                      mem, static_cast<cudaStream_t>(stream));
}

// Returns the cudaError_t of the launches (0 = success). Launches on
// `stream` and does not synchronise. ring (MEM, rows, 128) int8, 16-byte
// aligned, slot_bytes = rows * 128, mem = MEM (at most kOrderMaxMem); slot,
// row0 (n,) int32, slot in [0, MEM), row0 multiples of 8; order (n,) int32
// scratch for the copies' order (unused, and may be null, for local);
// partial (blocks, 128) f32 scratch; out (1, 128) f32. S slots, M windows a
// copy, ns rings (a divisor of depth), depth stages (1 .. 4); local = copy
// out of a column of colr rows of slot 0 held in shared memory; bulk = the
// bulk-copy route, else cp.async. The dynamic shared memory taken is that of
// ops/probe_cuda.copy_smem_bytes.
extern "C" int devo_copy_probe(const void* ring, const void* slot,
                               const void* row0, void* order, void* partial,
                               void* out, long long slot_bytes, int mem, int n,
                               int blocks, int S, int M, int ns, int depth,
                               int local, int colr, int bulk, void* stream) {
  if (blocks < 1 || depth < 1 || depth > kMaxStages || ns < 1 || depth % ns ||
      S < 1 || S > 2 || M < 1 || (local && colr < kWR + 8) ||
      (!local && (order == nullptr || mem < 1 || mem > kOrderMaxMem)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sorted = nullptr;
  if (!local) {
    const int err = launch_order(static_cast<const int*>(slot), static_cast<int*>(order),
                                 n, mem, st);
    if (err) return err;
    sorted = static_cast<const int*>(order);
  }
  const CopyArgs a{static_cast<const int8_t*>(ring), static_cast<const int*>(slot),
                   static_cast<const int*>(row0), sorted, static_cast<float*>(partial),
                   slot_bytes, n, S, M, ns, depth, colr};
  float* o = static_cast<float*>(out);
  if (bulk) return local ? launch<true, true>(a, blocks, o, st) : launch<true, false>(a, blocks, o, st);
  return local ? launch<false, true>(a, blocks, o, st) : launch<false, false>(a, blocks, o, st);
}
