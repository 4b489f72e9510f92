// The edge pipeline that ten correlation kernels share (csrc/corr.cu,
// corr_pair.cu, corr_pair2.cu, corr_mono2.cu, corr_mono3.cu, corr_group.cu,
// corr_group8.cu, corr_level_pipe.cu, corr_level_full.cu, corr_level.cu): a
// block walks
// its edges as one or two independent pipelines, each behind a ring of
// stages in shared memory that hold an edge's patch feature and the covering
// window of each of its levels (the union of the pixels' 8x8 tap grids),
// copied by cp.async with zeros off the image; the window product on the
// tensor cores (corr_mma.cuh) for bf16 patch features, on the CUDA cores
// (position_products) for f32 ones; a level whose window exceeds `cap`
// takes its taps from the ring, one dot a tap; the product surface, f32 in
// shared memory; then each output's four taps from it, blended.
//
// What a kernel chooses (PipeShape):
//   - levels an edge (2: both pyramid levels, coordinates divided in the
//     kernel; 1: one level, coordinates divided by the caller);
//   - edges a step (1, or 2: a pair of edges shares its barriers and its
//     stage, the m-tiles of both edges and levels are spread over the
//     pipeline's warps, each multiplied by its own edge's patch only);
//   - pipelines a block (1, or 2 of half the block's threads, each with its
//     own named barrier, so that one's waits overlap the other's work);
//   - threads a block (kPipeBlock = 512, or fewer for small blocks of which
//     one SM holds several);
//   - the edges a block walks (Order): a run of consecutive edges, blocks
//     b * run, ..., or every grid-th edge of a persistent grid, b, b + grid,
//     ...;
//   - the schedule (Sched): two barriers a step around the products and
//     one surface slot an edge and level (kTwoBarriers), or one pipeline of
//     one edge a step with two rotating slots a level and one barrier a
//     step, behind which the extraction of step s runs right after that
//     barrier and before the products of s + 1 (kSameStep), or after them,
//     one step behind (kLagged);
//   - whether each tap is rounded once to bf16 (round to nearest even)
//     before the ring slot's scale (the bf16 product surface of
//     CORR_KERNEL="g8c");
//   - whether the step writes the raw surface to device memory instead of
//     the blended row (the TPU kernel's own output, kept checkable);
//   - whether a pair's windows of a level are first gathered into one
//     contiguous run of rows ("mono2", the TPU's concatenation): edge 1's
//     rows are copied through the registers to follow edge 0's, behind
//     their own two barriers, and its m-tiles read them there;
//   - which parts of a step run (Part): all of them, the correlation, or
//     all but the extraction, the window product or the window copies: the
//     stage instances of csrc/corr_level_full.cu, which time those parts
//     apart and write what ops/corr.corr_level_stage defines (one level,
//     one edge a step, two barriers a step).
//
// Hazards of kTwoBarriers, for the reader of a pipeline's loop: two pipeline
// barriers a step s, A(s) before the products and B(s) after them. The stage
// of step s is written by copies started after B(s - pdepth), whose products
// read it before that barrier, and read by the products of s behind A(s)
// (which follows each thread's wait for its own copies); a gather rewrites
// it between A(s) and the products, behind its own barriers. The pipeline's
// surface slots are written by the products of s, behind A(s), which every
// thread passes only after its extraction of s-1, and read by the
// extraction of s, behind B(s). The index tables of step s + pdepth are
// written before B(s) by the pipeline's last warps, into the tables of
// step s + pdepth - kTables, whose extraction ended before A(s); they are
// read by the copies started after B(s), and by everything of that step
// later. Under Part::kNoMM the extraction of step s reads the windows of its
// stage instead of its surface slots, and the copies of step s + pdepth
// would overwrite them: there the copies start after the extraction and a
// third barrier, C(s). The commit groups keep their order, so every wait
// counts the same groups.
//
// Hazards of kSameStep and kLagged: one barrier Y(s) a step, after the
// products of step s and each thread's wait for its own copies of step
// s + 1. The phase between Y(s - 1) and Y(s) starts the copies of step
// s + pdepth - 1, runs the extraction of s - 1 and the products of s (in
// the schedule's order), and writes the index table of step s + pdepth.
//   - Stage reuse: the copies of step s + pdepth - 1 go into the stage of
//     step s - 1, whose last readers, its products, ran before Y(s - 1). The
//     products of s + pdepth - 1 read them behind Y(s + pdepth - 2), which
//     follows every thread's wait for them. So pdepth - 1 steps' copies fly
//     during a phase, and a pipeline needs two stages at least.
//   - Slot reuse two steps apart: the products of s write slot s % 2 before
//     Y(s), and the extraction of s reads it after Y(s). The next writer, the
//     products of s + 2, runs after Y(s + 1), which every thread passes only
//     after that extraction. The extraction of s and the products of s + 1
//     share a phase on the two different slots.
//   - Index-table slots: the table of step t is written before Y(t - pdepth)
//     and read by the copies of t after it, by the products of t and by the
//     extraction of t, which ends before Y(t + 1). So pdepth + 2 tables are
//     live in a phase (kTables holds that many), and the table written
//     before Y(s) takes the slot of step s + pdepth - kTables <= s - 2,
//     whose extraction ended before Y(s - 1).
// No atomics, and every sum in a fixed order: two launches give the same
// bits, and the order of an output's sums does not depend on the shape.
#pragma once

#include <type_traits>

#include "corr_mma.cuh"

namespace devo {

constexpr int kPipeBlock = 512;   // threads of a block, unless the shape says

template <typename G>
constexpr bool kMma = std::is_same<G, __nv_bfloat16>::value;

enum class Order { kRuns, kStrided };
enum class Sched { kTwoBarriers, kSameStep, kLagged };
// the parts of a step that run: all (the correlation), or all but the
// extraction (kNoExt: the surface's first values are written instead), the
// window product (kNoMM: each tap is the ring value of channel p % C) or the
// window copies (kNoDMA: the windows are zeroed once); the stage instances,
// in the order of ops/corr.STAGES
enum class Part { kAll, kNoExt, kNoMM, kNoDMA };

template <int Levels, int Step, int Pipes, int MaxDepth, bool Round,
          bool Surface, bool Gather, int Block = kPipeBlock,
          Order EdgeOrder = Order::kRuns, Sched Schedule = Sched::kTwoBarriers,
          Part Parts = Part::kAll>
struct PipeShape {
  static constexpr int kLevels = Levels;      // pyramid levels an edge
  static constexpr int kStep = Step;          // edges a step
  static constexpr int kPipes = Pipes;        // pipelines a block
  static constexpr int kMaxDepth = MaxDepth;  // stages of a block, at most
  static constexpr bool kRound = Round;       // bf16 taps before the scale
  static constexpr bool kSurface = Surface;   // write the raw surface
  static constexpr bool kGather = Gather;     // gather a pair's windows
  static constexpr int kBlock = Block;        // threads of a block
  static constexpr bool kStrided = EdgeOrder == Order::kStrided;
  static constexpr Sched kSched = Schedule;
  static constexpr Part kPart = Parts;
  static constexpr bool kOneBarrier = Schedule != Sched::kTwoBarriers;
  static constexpr int kSlots = kOneBarrier ? 2 : 1;   // a level's, an edge's
  static constexpr int kThreads = Block / Pipes;       // a pipeline's
  static constexpr int kWarps = kThreads / 32;
  // steps a pipeline holds index tables for: its stages and one ahead, and
  // with rotating slots one behind
  static constexpr int kTables = MaxDepth / Pipes + (kOneBarrier ? 2 : 1);
  // outputs of an edge a thread writes, at most
  static constexpr int kOuts =
      (Levels * kOut * kOut * kMaxPP + kThreads - 1) / kThreads;
  static_assert(Step == 1 || Step == 2, "one or two edges a step");
  static_assert(!Gather || Step == 2, "a gather takes a pair");
  static_assert(!Surface || (Levels == 1 && Step == 1), "one level's surface");
  static_assert(!kOneBarrier || (Pipes == 1 && Step == 1 && !Surface &&
                                 MaxDepth >= 2),
                "rotating slots: one pipeline of one edge, two stages");
  static_assert(kThreads % 32 == 0 && kWarps >= Step, "whole warps");
  static_assert(Parts == Part::kAll ||
                    (Levels == 1 && Step == 1 && !Surface &&
                     Schedule == Sched::kTwoBarriers),
                "a stage instance: one level, one edge a step, two barriers");
};

// The barrier of one pipeline of the block (named barrier 1 + pipe).
template <int kN>
__device__ __forceinline__ void pipe_sync(int pipe) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(pipe + 1), "n"(kN) : "memory");
}

// How a block lays out its shared memory: `depth` stages (depth / kPipes a
// pipeline), each kStep patch features (PP rows of gstride elements of G)
// and then the windows (cap rows of wstride elements of F) of level 0 of
// each edge, of level 1 of each edge; then kPipes x kSlots x kStep x kLevels
// surface slots of `slot` floats. The wrapper's ops/corr_cuda sums
// (mono_smem_bytes for corr.cu and corr_pair.cu, group_smem_bytes for
// corr_group.cu and corr_group8.cu, mono2_smem_bytes, mono3_smem_bytes,
// pair2_smem_bytes) are the same.
template <typename G, typename F, class S>
struct PipeLayout {
  int chans;      // channels of a staged row (C, or C rounded up to chunks)
  int gstride, wstride;
  size_t gbytes, stage;
  int ss, slot;
  __host__ __device__ PipeLayout(int PP, int C, int cap) {
    chans = kMma<G> ? mma_channels(C) : C;
    gstride = kMma<G> ? mma_stride(C) : C;
    wstride = kMma<G> ? mma_stride(C) : padded_stride<F>(C);
    gbytes = (static_cast<size_t>(PP) * gstride * sizeof(G) + 15) / 16 * 16;
    stage = S::kStep * (gbytes + S::kLevels * static_cast<size_t>(cap) *
                                     wstride * sizeof(F));
    ss = surface_stride(PP);
    slot = cap * ss > PP * kTaps * kTaps ? cap * ss : PP * kTaps * kTaps;
  }
  __host__ __device__ size_t bytes(int depth) const {
    return depth * stage + static_cast<size_t>(S::kPipes) * S::kSlots *
                               S::kStep * S::kLevels * slot * sizeof(float);
  }
};

template <typename G, typename F>
struct PipeArgs {
  PairArgs<G, F> p;         // level 1 unused with one level
  int depth;                // stages of a block, all pipelines'
  int run;                  // consecutive edges a block walks (Order::kRuns)
  __nv_bfloat16* surface;   // the raw surface (ceil(E / 8), rows, 128)
  int rows;                 //   and its rows, where the shape writes it
};

// Start the copies of a level's covering window into `win` (rows `stride`
// elements apart): positions 0 .. rows-1 of the ww-wide window at (wy0, wx0)
// in the ring slot fbase (H x W vectors of C elements), `chans` elements a
// row (a multiple of the copy); zeros past the window's n_pos positions, off
// the image and past C; by the kN threads tid of a pipeline. Where the
// copies of a row divide kN, a thread keeps to one copy of a row and walks
// the positions kN / (copies a row) apart, carrying their row and column
// along, so that the loop divides nothing. The caller commits the group.
template <int CB, int kN, typename F>
__device__ __forceinline__ void stage_covering(F* win, int stride, int rows,
                                               int chans, int C,
                                               const F* fbase, int n_pos,
                                               int ww, int wy0, int wx0, int H,
                                               int W, int tid) {
  constexpr int kEl = CB / static_cast<int>(sizeof(F));
  const int per_row = chans / kEl;
  auto src = [&](int pos, int r, int x) -> const F* {
    const int iy = wy0 + r, ix = wx0 + x;
    if (pos >= n_pos || iy < 0 || iy >= H || ix < 0 || ix >= W) return nullptr;
    return fbase + (static_cast<size_t>(iy) * W + ix) * C;
  };
  if (kN % per_row != 0) {
    stage_rows<CB>(win, stride, rows, chans, C,
                   [&](int pos) { return src(pos, pos / ww, pos % ww); },
                   fbase, tid, kN);
    return;
  }
  const int c = (tid % per_row) * kEl;
  const int step = kN / per_row;
  const int dr = step / ww, dx = step - dr * ww;
  int pos = tid / per_row;
  int r = pos / ww, x = pos - r * ww;
  for (; pos < rows; pos += step) {
    const F* s = c < C ? src(pos, r, x) : nullptr;
    cp_async_zfill<CB>(win + static_cast<size_t>(pos) * stride + c,
                       s ? s + c : fbase, s != nullptr);
    x += dx;
    r += dr;
    if (x >= ww) {
      x -= ww;
      ++r;
    }
  }
}

// A tap from its f32 sum and the slot's scale: rounded once to bf16 first
// where the shape asks for it.
template <bool kRound>
__device__ __forceinline__ float scaled_tap(float sum, float scale) {
  if constexpr (kRound)
    return __bfloat162float(__float2bfloat16_rn(sum)) * scale;
  else
    return sum * scale;
}

// The body of a pipeline kernel. G: type of the patch features, F: type of
// the rings (G or int8_t), S: its PipeShape.
template <typename G, typename F, class S>
__device__ __forceinline__ void edge_pipeline(const PipeArgs<G, F>& args) {
  constexpr int L = S::kLevels, kStep = S::kStep, kPipes = S::kPipes;
  constexpr int kN = S::kThreads, kW = S::kWarps, kParts = kStep * L;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ EdgePrep prep[kPipes][S::kTables][kStep];
  __shared__ __align__(16) float ce_next[kPipes][kStep][2 * kMaxPP];
  const PairArgs<G, F>& a = args.p;
  const int PP = a.PP, C = a.C, cap = a.cap;
  const int pdepth = args.depth / kPipes;    // stages of a pipeline
  const PipeLayout<G, F, S> lay(PP, C, cap);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int pipe = tid / kN;
  const int ptid = tid % kN;
  const int pwarp = ptid >> 5;
  const int n_out = L * kOut * kOut * PP;
  // the block's edges: first, first + 1, ... (a run) or first, first + grid,
  // ... (a persistent grid); n of them
  const int grid = gridDim.x;
  const int first = S::kStrided ? static_cast<int>(blockIdx.x)
                                : static_cast<int>(blockIdx.x) * args.run;
  const int n = S::kStrided ? (a.E - first + grid - 1) / grid
                            : min(args.run, a.E - first);
  // the pipeline's steps: every kPipes-th group of kStep edges of the block
  const int count = ((n + kStep - 1) / kStep - pipe + kPipes - 1) / kPipes;
  // the pipeline's surface slots, one an edge of a step and level (and of a
  // step's parity, with rotating slots)
  float* slots = reinterpret_cast<float*>(smem_raw + args.depth * lay.stage) +
                 pipe * S::kSlots * kParts * lay.slot;
  // this thread's outputs o = ptid + k * kN of every edge's row, decoded
  // once: o = ((ox * 7 + oy) * PP + p) * L + lvl, packed as
  // lvl | p << 1 | oy << 5 | ox << 8 (-1 past the row)
  int outs[S::kOuts];
#pragma unroll
  for (int k = 0; k < S::kOuts; ++k) {
    const int o = ptid + k * kN;
    const int q = o / L, p = q % PP, t = q / PP;
    outs[k] = o < n_out
                  ? (o % L) | p << 1 | (t % kOut) << 5 | (t / kOut) << 8
                  : -1;
  }

  // edge j of step s: the block's edge (s * kPipes + pipe) * kStep + j, in
  // stage pipe + kPipes * (s % pdepth), index table prep[pipe][s % kTables][j]
  auto local = [&](int s, int j) { return (s * kPipes + pipe) * kStep + j; };
  // (with one edge a step, s < count is the whole test)
  auto valid = [&](int s, int j) { return kStep == 1 || local(s, j) < n; };
  auto edge = [&](int s, int j) {
    const size_t l = local(s, j);
    return S::kStrided ? first + l * grid : first + l;
  };
  auto table = [&](int s, int j) -> EdgePrep& {
    return prep[pipe][s % S::kTables][j];
  };
  auto stage_of = [&](int s) {
    return smem_raw + (pipe + kPipes * (s % pdepth)) * lay.stage;
  };
  auto gstage = [&](int s, int j) {
    return reinterpret_cast<G*>(stage_of(s) + j * lay.gbytes);
  };
  auto window = [&](int s, int j, int lvl) {
    return reinterpret_cast<F*>(stage_of(s) + kStep * lay.gbytes) +
           static_cast<size_t>(lvl * kStep + j) * cap * lay.wstride;
  };
  auto slot_of = [&](int s, int j, int lvl) {
    return slots + ((s % S::kSlots) * kParts + j * L + lvl) * lay.slot;
  };
  // the levels' ring sizes, held apart so that no array of the arguments is
  // indexed at run time (that would copy the arguments to local memory)
  const int H0 = a.H[0], W0 = a.W[0], H1 = a.H[1], W1 = a.W[1];
  const F* const fmap0 = a.fmap[0];
  const F* const fmap1 = a.fmap[1];
  // the arguments without the scales, for the index tables of the edges
  // ahead, whose scales were loaded before the products
  PairArgs<G, F> unscaled = a;
  unscaled.dq[0] = unscaled.dq[1] = nullptr;
  auto ring_slot = [&](const EdgePrep& ep, int lvl) {
    const size_t frame_size = lvl ? static_cast<size_t>(H1) * W1 * C
                                  : static_cast<size_t>(H0) * W0 * C;
    return (lvl ? fmap1 : fmap0) + ep.frame * frame_size;
  };
  // rows of a level's staged window: its positions, padded to whole m-tiles
  // for the tensor cores; 0 where the level reads the ring
  auto rows_of = [&](const EdgePrep& ep, int lvl) {
    const int n_pos = ep.ww[lvl] * ep.wh[lvl];
    return kMma<G> ? (n_pos + 15) / 16 * 16 : n_pos;
  };
  // rows of edge j's window of a level in step s, 0 for an edge past the run
  auto rows_in = [&](int s, int j, int lvl) {
    return valid(s, j) ? rows_of(table(s, j), lvl) : 0;
  };
  // where the products read edge j's window of a level: where its copies
  // landed, or with a gather behind edge 0's rows
  auto part_window = [&](int s, int j, int lvl) -> const F* {
    if (S::kGather && j == 1)
      return window(s, 0, lvl) +
             static_cast<size_t>(rows_in(s, 0, lvl)) * lay.wstride;
    return window(s, j, lvl);
  };
  // the copies of step s into its stage, by the pipeline's threads
  auto start_copies = [&](int s) {
    for (int j = 0; j < kStep; ++j) {
      if (!valid(s, j)) continue;
      const EdgePrep& ep = table(s, j);
      const G* gsrc = a.gmap + static_cast<size_t>(ep.kk) * PP * C;
      stage_rows_any(gstage(s, j), lay.gstride, PP, lay.chans, C,
                     [&](int p) { return gsrc + static_cast<size_t>(p) * C; },
                     gsrc, ptid, kN);
      if constexpr (S::kPart == Part::kNoDMA) continue;   // no window copies
      for (int lvl = 0; lvl < L; ++lvl) {
        const int ww = ep.ww[lvl];
        if (ww == 0) continue;
        const int n_pos = ww * ep.wh[lvl];
        const int H = lvl ? H1 : H0, W = lvl ? W1 : W0;
        const int wx0 = ep.wx0[lvl], wy0 = ep.wy0[lvl];
        const F* fbase = ring_slot(ep, lvl);
        F* win = window(s, j, lvl);
        const int rows = rows_of(ep, lvl);
        switch (copy_bytes(C * static_cast<int>(sizeof(F)))) {
#define DEVO_STAGE(CB)                                                    \
  stage_covering<CB, kN>(win, lay.wstride, rows, lay.chans, C, fbase,     \
                         n_pos, ww, wy0, wx0, H, W, ptid)
          case 16: DEVO_STAGE(16); break;
          case 8: DEVO_STAGE(8); break;
          default: DEVO_STAGE(4); break;
#undef DEVO_STAGE
        }
      }
    }
  };

  // (warp kW - kStep + j) edge j of step t: its coordinates, indices and
  // scales, loaded before the products that hide their latency and written
  // as its index table after them
  struct Ahead {
    bool on;
    float2 c;
    int kk, jj;
    float q;          // lane l < L: level l's scale
  };
  const int ja = pwarp - (kW - kStep);
  auto load_ahead = [&](int t) {
    Ahead ah{ja >= 0 && t < count && valid(t, ja), make_float2(0.0f, 0.0f), 0,
             0, 1.0f};
    if (ah.on) {
      const size_t en = edge(t, ja);
      if (lane < PP)
        ah.c = *reinterpret_cast<const float2*>(a.coords + (en * PP + lane) * 2);
      ah.kk = a.kk[en];
      ah.jj = a.jj[en];
      const float* dq = lane ? a.dq[1] : a.dq[0];
      if (lane < L && dq) ah.q = dq[ah.jj];
    }
    return ah;
  };
  auto store_ahead = [&](const Ahead& ah, int t) {
    if (!ah.on) return;
    float* ce = ce_next[pipe][ja];
    if (lane < PP) {
      ce[2 * lane] = ah.c.x;
      ce[2 * lane + 1] = ah.c.y;
    }
    __syncwarp();
    EdgePrep& next = table(t, ja);
    prep_edge<L>(next, unscaled, ce, ah.kk, ah.jj, lane);
    if (lane < L) next.q[lane] = ah.q;
    __syncwarp();
  };

  // the surface of each edge and level of step s into its slot (none of a
  // staged window under kNoMM)
  constexpr bool kProducts = S::kPart != Part::kNoMM;
  auto products = [&](int s) {
    EdgePrep* const tabs = prep[pipe][s % S::kTables];   // step s's tables
    if constexpr (kMma<G>) {
      // the m-tiles of every edge and level, one warp each in turn
      int tiles[kParts];
      int n_tiles = 0;
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        tiles[part] = kProducts ? rows_in(s, part / L, part % L) / 16 : 0;
        n_tiles += tiles[part];
      }
      for (int tile = pwarp; tile < n_tiles; tile += kW) {
        int part = 0, t = tile;   // (constant indices: tiles stays in registers)
#pragma unroll
        for (int q = 0; q + 1 < kParts; ++q)
          if (part == q && t >= tiles[q]) {
            t -= tiles[q];
            part = q + 1;
          }
        const int j = part / L, lvl = part % L;
        const int m0 = t * 16;
        const F* win = part_window(s, j, lvl);
        const G* g = gstage(s, j);
        float d[2][4] = {};
        for (int c0 = 0; c0 < lay.chans; c0 += kMmaChunk) {
          ChunkB b;
          b.load(g, lay.gstride, PP, c0, lane);
          tile_chunk(d, win, lay.wstride, m0, c0, b, lane);
        }
        store_tile<S::kRound>(slot_of(s, j, lvl), lay.ss, m0, d, PP,
                              tabs[j].q[lvl], lane);
      }
    } else {
      // one window position a thread, against every pixel
      int rows[kParts];
      int n_rows = 0;
#pragma unroll
      for (int part = 0; part < kParts; ++part) {
        rows[part] = kProducts ? rows_in(s, part / L, part % L) : 0;
        n_rows += rows[part];
      }
      for (int t = ptid; t < n_rows; t += kN) {
        int part = 0, pos = t;
#pragma unroll
        for (int q = 0; q + 1 < kParts; ++q)
          if (part == q && pos >= rows[q]) {
            pos -= rows[q];
            part = q + 1;
          }
        const int j = part / L, lvl = part % L;
        const float q = tabs[j].q[lvl];
        const G* g = gstage(s, j);
        const F* vec = part_window(s, j, lvl) + static_cast<size_t>(pos) * lay.wstride;
        float* dst = slot_of(s, j, lvl) + pos * lay.ss;
        if (PP == 9) {
          float acc[9];
          position_products<9>(g, vec, C, acc);
#pragma unroll
          for (int p = 0; p < 9; ++p) dst[p] = scaled_tap<S::kRound>(acc[p], q);
        } else {
          position_products_any(g, vec, C, PP, dst, 1);
          for (int p = 0; p < PP; ++p) dst[p] = scaled_tap<S::kRound>(dst[p], q);
        }
      }
    }
    // a level without a staged window: its taps from the ring, (PP, 8, 8)
    // (none under kNoExt, whose rows leave them out; under kNoMM a tap is
    // the ring value of channel p % C)
    if constexpr (S::kPart == Part::kNoExt) return;
    for (int part = 0; part < kParts; ++part) {
      const int j = part / L, lvl = part % L;
      if (!valid(s, j) || tabs[j].ww[lvl] > 0) continue;
      const EdgePrep& ep = tabs[j];
      const int H = lvl ? H1 : H0, W = lvl ? W1 : W0;
      const F* fbase = ring_slot(ep, lvl);
      const G* g = gstage(s, j);
      float* slot = slot_of(s, j, lvl);
      for (int it = ptid; it < PP * kTaps * kTaps; it += kN) {
        const int p = it / (kTaps * kTaps);
        const int tap = it - p * kTaps * kTaps;
        const int iy = ep.y0[lvl][p] + tap / kTaps - kRadius;
        const int ix = ep.x0[lvl][p] + tap % kTaps - kRadius;
        if (iy < 0 || iy >= H || ix < 0 || ix >= W) {
          slot[it] = 0.0f;
          continue;
        }
        const F* f = fbase + (static_cast<size_t>(iy) * W + ix) * C;
        if constexpr (kProducts)
          slot[it] = scaled_tap<S::kRound>(
              dot_any(g + static_cast<size_t>(p) * lay.gstride, f, C),
              ep.q[lvl]);
        else
          slot[it] = to_float(f[p % C]);
      }
    }
  };

  // the outputs of step s from its slots: the blended rows, or the raw
  // surface
  auto extract = [&](int s) {
    EdgePrep* const tabs = prep[pipe][s % S::kTables];
    for (int j = 0; j < kStep; ++j) {
      if (!valid(s, j)) continue;
      const EdgePrep& ep = tabs[j];
      if constexpr (S::kSurface) {
        // the raw surface: rows of the window's positions, or of the taps
        // where the window was not staged; lane 16 * (e % 8) + p
        const size_t e = edge(s, j);
        const int ww = ep.ww[0];
        const int n_rows = ww > 0 ? ww * ep.wh[0] : kTaps * kTaps;
        const float* slot = slot_of(s, j, 0);
        __nv_bfloat16* dst = args.surface +
                             (e / 8) * static_cast<size_t>(args.rows) * 128 +
                             (e % 8) * 16;
        for (int it = ptid; it < n_rows * 16; it += kN) {
          const int row = it >> 4, p = it & 15;
          const float v = p >= PP ? 0.0f
                          : ww > 0 ? slot[row * lay.ss + p]
                                   : slot[p * kTaps * kTaps + row];
          dst[static_cast<size_t>(row) * 128 + p] = __float2bfloat16_rn(v);
        }
      } else if constexpr (S::kPart == Part::kNoExt) {
        // no extraction: the surface's first values, output o the window
        // position o / PP and pixel o % PP; 0 past the window and for an
        // edge whose window was not staged
        float* dst = a.out + edge(s, j) * n_out;
        const float* slot = slot_of(s, j, 0);
        const int n_val = ep.ww[0] > 0 ? ep.ww[0] * ep.wh[0] * PP : 0;
        for (int o = ptid; o < n_out; o += kN)
          dst[o] = o < n_val ? slot[(o / PP) * lay.ss + o % PP] : 0.0f;
      } else {
        // extraction and blend, from the surface or the taps
        float* dst = a.out + edge(s, j) * n_out;
#pragma unroll
        for (int k = 0; k < S::kOuts; ++k) {
          if (outs[k] < 0) continue;
          const int o = ptid + k * kN;
          const int lvl = outs[k] & 1, p = outs[k] >> 1 & 15;
          const int oy = outs[k] >> 5 & 7, ox = outs[k] >> 8;
          const float fx = ep.fx[lvl][p], fy = ep.fy[lvl][p];
          const float* slot = slot_of(s, j, lvl);
          const int ww = ep.ww[lvl];
          if (ww > 0) {
            const int r = ep.y0[lvl][p] + oy - kRadius - ep.wy0[lvl];
            const int c = ep.x0[lvl][p] + ox - kRadius - ep.wx0[lvl];
            if constexpr (kProducts) {
              dst[o] = blend_at(slot + (r * ww + c) * lay.ss + p, lay.ss,
                                ww * lay.ss, fx, fy);
            } else {
              // no product: channel p % C of the four window positions
              const F* v = window(s, j, lvl) +
                           static_cast<size_t>(r * ww + c) * lay.wstride +
                           p % C;
              const size_t dy = static_cast<size_t>(ww) * lay.wstride;
              const float four[4] = {to_float(v[0]), to_float(v[lay.wstride]),
                                     to_float(v[dy]),
                                     to_float(v[dy + lay.wstride])};
              dst[o] = blend_at(four, 1, 2, fx, fy);
            }
          } else {
            dst[o] = blend_frac(slot + p * kTaps * kTaps, ox, oy, fx, fy);
          }
        }
      }
    }
  };

  // the index tables of the pipeline's first pdepth steps, a warp an edge
  for (int it = pwarp; it < pdepth * kStep; it += kW) {
    const int s = it / kStep, j = it % kStep;
    if (s < count && valid(s, j)) {
      const size_t e = edge(s, j);
      prep_edge<L>(table(s, j), a, a.coords + e * PP * 2, a.kk[e], a.jj[e],
                   lane);
    }
  }
  if constexpr (S::kPart == Part::kNoDMA) {
    // the windows are never copied: the pipeline's are zeroed once
    for (int s = 0; s < pdepth; ++s) {
      uint4* w = reinterpret_cast<uint4*>(stage_of(s) + kStep * lay.gbytes);
      const int n_words =
          static_cast<int>((lay.stage - kStep * lay.gbytes) / 16);
      for (int i = ptid; i < n_words; i += kN)
        w[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  pipe_sync<kN>(pipe);

  if constexpr (S::kOneBarrier) {
    // the copies of the first pdepth - 1 steps, a group a step; then
    // Y(-1): everyone's copies of step 0 landed
    for (int s = 0; s + 1 < pdepth; ++s) {
      if (s < count) start_copies(s);
      cp_async_commit();
    }
    cp_async_wait_pending(pdepth - 2);
    pipe_sync<kN>(pipe);
    for (int s = 0; s <= count; ++s) {
      // the stage of step s - 1 is read no more: the copies of s + pdepth - 1
      if (s + pdepth - 1 < count) start_copies(s + pdepth - 1);
      cp_async_commit();              // a group every step, empty at the end
      const Ahead ah = load_ahead(s + pdepth);
      if constexpr (S::kSched == Sched::kLagged) {
        if (s < count) products(s);
        if (s > 0) extract(s - 1);
      } else {
        if (s > 0) extract(s - 1);
        if (s < count) products(s);
      }
      store_ahead(ah, s + pdepth);
      if (s < count) {
        cp_async_wait_pending(pdepth - 2);  // this thread's copies of s + 1
        pipe_sync<kN>(pipe);                // Y(s): everyone's; surfaces done
      }
    }
  } else {
    // the copies of the first pdepth steps, a group a step
    for (int s = 0; s < pdepth; ++s) {
      if (s < count) start_copies(s);
      cp_async_commit();
    }
    for (int s = 0; s < count; ++s) {
      const Ahead ah = load_ahead(s + pdepth);
      cp_async_wait_pending(pdepth - 1);  // this thread's copies of step s
      pipe_sync<kN>(pipe);                // A(s): everyone's; slots free

      if constexpr (S::kGather) {
        // edge 1's rows of each level moved to follow edge 0's: all loads of
        // a round, a barrier, all stores, a barrier (the rows move down, so a
        // later round reads nothing an earlier one wrote)
        if (valid(s, 1)) {
          constexpr int kHeld = 8;
          const int per_row = lay.chans * static_cast<int>(sizeof(F)) / 16;
          const int n0 = rows_in(s, 1, 0) * per_row;
          const int total = n0 + (L > 1 ? rows_in(s, 1, L - 1) * per_row : 0);
          auto piece = [&](int i, bool dst) {
            const int lvl = i >= n0;
            const int k = i - lvl * n0, r = k / per_row, c = k - r * per_row;
            const F* base = dst ? part_window(s, 1, lvl) : window(s, 1, lvl);
            return reinterpret_cast<uint4*>(const_cast<F*>(base) +
                                            static_cast<size_t>(r) * lay.wstride) +
                   c;
          };
          for (int base = 0; base < total; base += kHeld * kN) {
            uint4 held[kHeld];
#pragma unroll
            for (int h = 0; h < kHeld; ++h) {
              const int i = base + h * kN + ptid;
              if (i < total) held[h] = *piece(i, false);
            }
            pipe_sync<kN>(pipe);
#pragma unroll
            for (int h = 0; h < kHeld; ++h) {
              const int i = base + h * kN + ptid;
              if (i < total) *piece(i, true) = held[h];
            }
            pipe_sync<kN>(pipe);
          }
        }
      }

      products(s);
      store_ahead(ah, s + pdepth);
      pipe_sync<kN>(pipe);                // B(s): the surfaces are complete

      if constexpr (!kProducts) {
        extract(s);                       // reads the windows of step s
        pipe_sync<kN>(pipe);              // C(s): read no more
      }
      // the stage of step s is read no more: the copies of step s + pdepth
      if (s + pdepth < count) start_copies(s + pdepth);
      cp_async_commit();              // a group every step, empty at the end
      if constexpr (kProducts) extract(s);
    }
  }
}

// Launch a pipeline kernel of shape S on `grid` blocks with `smem` bytes of
// dynamic shared memory; returns the cudaError_t.
template <class S, typename Kernel, typename Args>
int launch_pipe(Kernel kernel, const Args& args, int grid, size_t smem,
                cudaStream_t st) {
  const cudaError_t err = allow_shared_memory(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, S::kBlock, smem, st>>>(args);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of a pipeline kernel of shape S that one SM of the current device
// holds with `smem` bytes of dynamic shared memory, or minus the
// cudaError_t.
template <class S, typename Kernel>
int pipe_blocks_per_sm(Kernel kernel, size_t smem) {
  cudaError_t err = allow_shared_memory(kernel, smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        S::kBlock, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace devo

// The four (patch feature, ring) type pairs, from the C interfaces' flags
// g_bf16 and ring_i8.
#define DEVO_PIPE_TYPES(CALL)                                             \
  (g_bf16 ? (ring_i8 ? CALL(__nv_bfloat16, int8_t)                        \
                     : CALL(__nv_bfloat16, __nv_bfloat16))                \
          : (ring_i8 ? CALL(float, int8_t) : CALL(float, float)))
