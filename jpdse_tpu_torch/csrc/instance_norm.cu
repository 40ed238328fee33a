// Fused InstanceNorm (+ReLU) (+residual) (kernel K3) and its backward, for
// Hopper (sm_90a).
//
// Replaces the forward of jpdse_tpu/ops/pallas/instance_norm.py::
// fused_instance_norm (_kernel, _forward): for x (B, H, W, C) in NHWC,
// y = (x - mean) * rsqrt(var + eps) over each (b, c)'s H x W slab, with fp32
// statistics and the biased variance, then ReLU if asked, then the residual
// added in fp32, then one cast to x's type.
//
// Bound: device-memory bytes, one read of x (and of the residual) and one
// write of y. At the flagship's largest slab, (1, 512, 1024, 64) bf16, that
// is 67.1 MB read and 67.1 MB written: 40 us at 3.35 TB/s.
//
// The TPU kernel held a whole slab in VMEM. Here a slab is split across the
// blocks of one cooperative launch, each block resident on its SM for the
// whole call (grid = co-resident blocks, from the occupancy API and the
// device's SM count):
//   1. statistics: block k takes a chunk of rows of one (b, channel tile)
//      slab (ops/instance_norm.py::plan mirrors the partition). A thread
//      owns V channels (16 bytes: 8 bf16 or 4 fp32) of every P-th row and
//      reads them with 16-byte loads, R rows at a time: the batch's mean
//      and M2 about it in registers, then one Chan merge into the running
//      (count, mean, M2), so there is one division per R rows and no raw
//      sum of squares. What it reads it also keeps in shared memory, as
//      far as the 193 KiB there go. The block merges its threads in a
//      fixed tree and writes one partial per (b, chunk, c);
//   2. grid barrier; then one warp per (b, c), across the grid, merges the
//      chunks' partials in a fixed order into mean and rstd; grid barrier;
//   3. normalize: each block walks its rows again in reverse order of
//      phase 1: the rows read last, still in L2, first, and the rows it
//      kept in shared memory last, without touching device memory.
// No float atomics, so two runs give the same bits.
//
// The backward (instance_norm_bwd_kernel) replaces _fused_in_bwd of the same
// file, the custom VJP JAX differentiates K3 through: with xhat = (x - mean)
// * rstd from the forward's statistics and g' = g * [xhat > 0] under ReLU,
// dx = rstd * (g' - mean(g') - xhat * mean(g' * xhat)), one cast to x's type;
// the residual's gradient is g itself and needs no kernel. Bound: bytes, one
// read of x and of g and one write of dx (at (1, 512, 1024, 64) bf16, 3 x
// 67.1 MB: 60 us at 3.35 TB/s). dx needs two means over the whole slab, so
// each byte of x and g is wanted twice, once on each side of a grid
// barrier: the second read from device memory is what costs, and what the
// design cuts. The same cooperative launch and partition as the forward,
// one 512-thread block per SM with all its shared memory: kRing ring slots
// and then cache_iters cache slots, each one x word and one g word a thread
// (ops/instance_norm.py::bwd_cache_iters, bwd_walk mirror the slots).
//   1. a block sums g' and g' * xhat over its chunk's rows in fp32. Every
//      word comes in by 16-byte cp.async, so loads stay in flight without
//      holding registers: its first cache_iters loop iterations (counted
//      across its items, as the forward counts them) into the cache, all of
//      an item's at once, the rest through the ring, each slot refilled as
//      it is summed. The block merges its pixel lanes in a fixed tree (the
//      reduction area lies over the drained ring) and writes one partial
//      per (b, chunk, c); grid barrier;
//   2. one warp per (b, c) adds the chunks in a fixed order into the two
//      means, 8 loads a lane in flight; grid barrier;
//   3. each block walks phase 1's steps in reverse, its uncached rows
//      through the ring from the last read, then the cached ones, which
//      touch no device memory. dx goes out by plain stores: the next
//      layer's backward reads it, from L2 where it can (evict-first stores
//      measured alike alone and left it to device memory).
// Where a block's rows fit its cache (the serving path's res-block slabs)
// every byte is read from device memory once; at the largest slab the cache
// holds 11 of a block's 63 iterations. On an H100 the L2 kept no measurable
// part of the second read (reverse order, evict-last and evict-first hints
// all measured alike); see PERF.md.
//
// The partial-statistics form (the spatial axis, parallel/spatial.py): a
// slab is one rank's rows of a global slab held by S ranks, so the
// statistics must be merged across ranks between the kernel's phases. The
// same work in four launches, the host gathering across the group between
// them (ops/instance_norm.py::FusedInstanceNorm):
//   forward: instance_norm_stats_kernel (this rank's (count, mean, M2) per
//     (b, c)); the host gathers the S ranks' triples;
//     instance_norm_apply_kernel (the S triples merged in rank order, so
//     every rank holds the same bits, then this rank's rows normalized,
//     ReLU, the fp32 residual, one cast; x is read a second time);
//   backward: instance_norm_bwd_sums_kernel (the fp32 sums of g' and
//     g' * xhat per (b, c), sums, not means); the host gathers them;
//     instance_norm_bwd_dx_kernel (the S ranks' sums added in rank order
//     and divided by the global count, then dx).
// Bound: bytes. Forward, two reads of x and one write of y; backward, two
// reads each of x and g and one write of dx.
//
// The apply and dx launches are element-wise once the statistics are
// merged: their bound is x (and the residual, or g) read and y (or dx)
// written, 5-80 us at the training step's rank slabs. What held their
// first design back was fixed cost, not bytes: one 512-thread block per 8
// loop iterations (thousands of blocks at the largest slabs, 32-84 at the
// smallest, on 132 SMs), every thread merging the S ranks' statistics of
// its channels before its first load of x, and one load in flight a
// thread (a break inside the unrolled loop). Their design:
//   - part_plan.h's apply partition: one 256-thread CTA per (slab, chunk),
//     a slab a batch element's channel tile of at most kApplyTileWords
//     words, its rows cut evenly into chunks; each CTA walks its contiguous
//     rows. The launch's target is a CTA for each 128 KiB of x, at least
//     two CTAs an SM (the launch bounds hold each CTA's registers to half
//     an SM's) and at most eight; an empty slab keeps one CTA (the apply's
//     writes the merged mean and rstd);
//   - the statistics merged once a CTA: its threads split the tile's
//     channels, each issuing the loads of the ranks' parts of its channel
//     (four ranks at a time) before it folds them in rank order (the same
//     merge as before), into shared memory, one barrier; the x (and
//     residual, or g) loads of the CTA's first step are issued before the
//     merge, so the two overlap;
//   - loads in flight: each step's loads (kApplyBatch 16-byte words of each
//     operand a thread; half that for the dx on bf16) are all issued before
//     any is used, with a masked tail and no break.
// At the largest slabs both run at 84-89% of the bytes bound, the rate an
// H100 gave such streams at every grid, tile and batch tried (PERF.md); the
// smaller slabs gain most.
// No atomics and no grid barrier: every CTA of a slab merges the same
// parts in the same order, so two runs give the same bits.
//
// The stats and sums launches read x (and g) once and write a few floats
// per (b, c): their bound is that read, 2.5 us for a rank's slab of the
// training step's deepest sites and 10-80 us for the largest, so a fixed
// cost per launch (a cooperative launch, a grid barrier) or a serial tail
// (one block merging many partials) shows at every size. Their design:
//   - an ordinary launch of one 256-thread CTA per (slab, chunk), slabs
//     (batch element, channel tile of at most kPartTileWords words) in
//     order; part_plan.h holds the partition, and the wrapper sizes the
//     workspace from the same code (instance_norm_part_plan). A chunk is
//     whole stages of 4 words a thread (16 KiB of x where a word is 16
//     bytes), kPartMinStages at the least, more where the launch would
//     have more than kPartMaxCtas CTAs (one an SM). A small slab gets few
//     CTAs, a large one fills the card;
//   - loads through a ring of shared-memory stages (Ring): where the tile is
//     the whole row, a stage is one byte range, copied by one cp.async.bulk
//     an operand that completes on the slot's mbarrier; else each thread
//     copies its own words by 16-byte cp.async and waits for its own
//     copies. The threads fold a stage's words from shared memory (the
//     same batched Chan merge as the one-launch forward, or the same fp32
//     sums as its backward) and the slot is refilled part_stages stages
//     ahead. Words of one channel (the launchers' vec 0: C not a multiple
//     of 16 bytes' worth, or an unaligned tensor) are read by each thread
//     straight into registers;
//   - a fixed-order merge in place of the grid barrier: each CTA merges its
//     pixel lanes in a fixed tree, writes its chunk's partial, and one of
//     its threads takes a ticket on its slab (one acquire-release integer
//     atomic after a barrier). The CTA that takes a slab's last ticket
//     copies the slab's partials into shared memory by cp.async, every copy
//     in flight at once, and merges them with threads over channels, each
//     channel's chunks cut into contiguous runs merged in chunk order and
//     the runs then in order. No float atomics: the order of every float
//     operation is fixed by the plan, whatever order the CTAs finish in, so
//     two runs give the same bits;
//   - what bounds the launch beyond its bytes is that merge, after the last
//     CTA's loads: three dependent round trips to L2 (the partial's store
//     before the release, the atomic, the copy; 2-4 us on an H100, PERF.md)
//     on one SM a slab, whatever the slab's size, plus its copy and chain,
//     which grow with chunks x channels. The plan keeps those within one
//     batch of shared memory (kPartMergeBytes) by narrowing the tile, and
//     where a narrower tile leaves every slab one chunk it takes that and
//     merges nothing; tiles below 8 words (128 bytes of a row) slow the
//     loads, so it narrows no further than kPartTileMin;
//   - the counters: one int a slab, in a buffer the wrapper keeps per
//     device and stream, zeroed once when allocated; the CTA that takes a
//     counter's last ticket sets it back to 0, so each launch leaves the
//     buffer as it found it for the next launch on the stream (launches on
//     one stream run in order);
//   - a slab of one chunk (a small one, or an empty slab: hw 0, one chunk
//     of no rows, whose CTAs write the (0, 0, 0) or (0, 0) parts) writes its
//     result straight from the CTA's tree, with no partial and no ticket.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "part_plan.h"

// 1: a stage of a tile that is the whole row comes by one cp.async.bulk copy
// an operand; 0: by each thread's 16-byte cp.async, as narrower tiles do.
#ifndef K3_PART_BULK
#define K3_PART_BULK 1
#endif

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 512;
constexpr int kBatch = 4;  // rows a thread loads before it folds them into its moments

struct Plan {
  long long hw, rows_per_chunk;
  int batch, c, chunks;
  int groups;      // channel groups of V channels: c / V
  int tile;        // channel groups per block item: min(groups, kThreads)
  int tiles;       // channel tiles: ceil(groups / tile)
  int pix;         // pixel lanes of a block: kThreads / tile
  int cache_iters; // loop iterations whose loads fit in the shared-memory cache
};

// V values of type T, loaded and stored as one word.
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float& d, float v) { d = v; }
__device__ __forceinline__ void from_f(bf16& d, float v) { d = __float2bfloat16(v); }

// V floats into one word of T, two at a time for bf16 (one packing convert).
template <typename T, int V>
__device__ __forceinline__ void pack(Vec<T, V>& o, const float* f) {
  if constexpr (sizeof(T) == 2 && V % 2 == 0) {
#pragma unroll
    for (int v = 0; v < V; v += 2) {
      *reinterpret_cast<__nv_bfloat162*>(&o.v[v]) = __floats2bfloat162_rn(f[v], f[v + 1]);
    }
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) from_f(o.v[v], f[v]);
  }
}

struct Moments {
  float n, mean, m2;
};

// Chan et al.'s merge of two (count, mean, M2) summaries.
__device__ __forceinline__ Moments merge(Moments a, Moments b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  return {n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

// Block blk's items are q = blk, blk + grid, ... < batch * tiles * chunks;
// item q is chunk q % chunks of slab q / chunks = (b, channel tile).
struct Item {
  int b, tile, g0;       // batch element, channel tile, its first channel group
  long long r0, r1;      // rows [r0, r1)
  int iters;             // ceil((r1 - r0) / pix)
};

__device__ __forceinline__ Item item(const Plan& p, int q) {
  Item it;
  const int slab = q / p.chunks, chunk = q % p.chunks;
  it.b = slab / p.tiles;
  it.tile = slab % p.tiles;
  it.g0 = it.tile * p.tile;
  it.r0 = chunk * p.rows_per_chunk;
  it.r1 = min(it.r0 + p.rows_per_chunk, p.hw);
  it.iters = static_cast<int>((it.r1 - it.r0 + p.pix - 1) / p.pix);
  return it;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
instance_norm_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                     float* __restrict__ partial, float* __restrict__ stats, Plan p, int relu,
                     float eps) {
  using W = Vec<T, V>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* red_n = reinterpret_cast<float*>(smem);  // per thread: count, then V means, V M2s
  float* red_mean = red_n + kThreads;
  float* red_m2 = red_mean + kThreads * V;
  W* cache = reinterpret_cast<W*>(red_m2 + kThreads * V);

  const int tid = threadIdx.x;
  const int lane_p = tid / p.tile, gl = tid % p.tile;  // pixel lane, channel group in the tile
  const int items = p.batch * p.tiles * p.chunks;
  const W* xv = reinterpret_cast<const W*>(x);
  const W* rv = reinterpret_cast<const W*>(res);
  W* yv = reinterpret_cast<W*>(y);

  // -- 1. statistics --------------------------------------------------------
  int it_count = 0;  // loop iterations so far: the shared-memory cache's index
  for (int q = blockIdx.x; q < items; q += gridDim.x) {
    const Item w = item(p, q);
    const int g = w.g0 + gl;
    const bool active = lane_p < p.pix && g < p.groups;
    const long long base = static_cast<long long>(w.b) * p.hw * p.groups + g;
    float n = 0.f, mean[V], m2[V];
#pragma unroll
    for (int v = 0; v < V; ++v) mean[v] = m2[v] = 0.f;
    for (int k0 = 0; k0 < w.iters; k0 += kBatch) {
      W buf[kBatch];
      int nb = 0;
      // all of the batch's loads in flight before any use of them
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk) {
        const long long r = w.r0 + lane_p + static_cast<long long>(k0 + kk) * p.pix;
        if (active && k0 + kk < w.iters && r < w.r1) {
          buf[kk] = xv[base + r * p.groups];
          ++nb;
        }
      }
      if (nb == 0) continue;
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk) {
        const int slot = it_count + k0 + kk;
        if (kk < nb && slot < p.cache_iters) cache[slot * kThreads + tid] = buf[kk];
      }
      const float nbf = static_cast<float>(nb), inv = 1.f / nbf;
      const float n_new = n + nbf, f = nbf / n_new;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float s = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBatch; ++kk) if (kk < nb) s += to_f(buf[kk].v[v]);
        const float mb = s * inv;
        float q2 = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBatch; ++kk) {
          if (kk < nb) {
            const float d = to_f(buf[kk].v[v]) - mb;
            q2 += d * d;
          }
        }
        const float delta = mb - mean[v];
        mean[v] += delta * f;
        m2[v] += q2 + delta * delta * n * f;
      }
      n = n_new;
    }
    it_count += w.iters;

    // the block's pixel lanes, merged in a fixed tree
    red_n[tid] = n;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red_mean[tid * V + v] = mean[v];
      red_m2[tid * V + v] = m2[v];
    }
    __syncthreads();
    for (int s = 1; s < p.pix; s *= 2) {
      if (lane_p % (2 * s) == 0 && lane_p + s < p.pix) {
        const int o = tid + s * p.tile;
        const float na = red_n[tid], nb = red_n[o];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const Moments m = merge({na, red_mean[tid * V + v], red_m2[tid * V + v]},
                                  {nb, red_mean[o * V + v], red_m2[o * V + v]});
          red_mean[tid * V + v] = m.mean;
          red_m2[tid * V + v] = m.m2;
        }
        red_n[tid] = na + nb;
      }
      __syncthreads();
    }
    if (lane_p == 0 && g < p.groups) {
      const int chunk = q % p.chunks;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float* o = partial + ((static_cast<long long>(w.b) * p.chunks + chunk) * p.c +
                              g * V + v) * 3;
        o[0] = red_n[tid];
        o[1] = red_mean[tid * V + v];
        o[2] = red_m2[tid * V + v];
      }
    }
    __syncthreads();  // the reduction area is reused by the next item
  }

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  grid.sync();

  // -- 2. finalize: one warp per (b, c), chunks merged in a fixed order -----
  {
    const int lane = tid % 32;
    const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
    for (long long i = (static_cast<long long>(blockIdx.x) * kThreads + tid) / 32;
         i < static_cast<long long>(p.batch) * p.c; i += warps) {
      const long long b = i / p.c, ch = i % p.c;
      Moments t{0.f, 0.f, 0.f};
      for (int k = lane; k < p.chunks; k += 32) {
        const float* q = partial + ((b * p.chunks + k) * p.c + ch) * 3;
        t = merge(t, Moments{q[0], q[1], q[2]});
      }
      for (int off = 16; off > 0; off >>= 1) {
        const Moments o{__shfl_down_sync(0xffffffffu, t.n, off),
                        __shfl_down_sync(0xffffffffu, t.mean, off),
                        __shfl_down_sync(0xffffffffu, t.m2, off)};
        t = merge(t, o);
      }
      if (lane == 0) {
        stats[2 * i] = t.mean;
        stats[2 * i + 1] = 1.0f / sqrtf(t.m2 / t.n + eps);
      }
    }
  }
  grid.sync();

  // -- 3. normalize, items and rows in reverse order of phase 1 -------------
  int first = blockIdx.x, last = -1;
  for (int q = blockIdx.x; q < items; q += gridDim.x) last = q;
  for (int q = last; q >= first; q -= gridDim.x) {
    const Item w = item(p, q);
    it_count -= w.iters;
    const int g = w.g0 + gl;
    if (!(lane_p < p.pix && g < p.groups)) continue;
    const long long base = static_cast<long long>(w.b) * p.hw * p.groups + g;
    float mean[V], rstd[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float* st = stats + 2 * (static_cast<long long>(w.b) * p.c + g * V + v);
      mean[v] = st[0];
      rstd[v] = st[1];
    }
    for (int k0 = w.iters - 1; k0 >= 0; k0 -= kBatch) {
      W buf[kBatch], rb[kBatch];
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk) {
        const int k = k0 - kk;
        const long long r = w.r0 + lane_p + static_cast<long long>(k) * p.pix;
        if (k >= 0 && r < w.r1) {
          const int slot = it_count + k;
          buf[kk] = slot < p.cache_iters ? cache[slot * kThreads + tid] : xv[base + r * p.groups];
          if (res != nullptr) rb[kk] = rv[base + r * p.groups];
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk) {
        const int k = k0 - kk;
        const long long r = w.r0 + lane_p + static_cast<long long>(k) * p.pix;
        if (k >= 0 && r < w.r1) {
          W o;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            float t = (to_f(buf[kk].v[v]) - mean[v]) * rstd[v];
            if (relu) t = fmaxf(t, 0.f);
            if (res != nullptr) t += to_f(rb[kk].v[v]);
            from_f(o.v[v], t);
          }
          yv[base + r * p.groups] = o;
        }
      }
    }
  }
}

// -- K3 backward ---------------------------------------------------------------

// Loop iterations of x and g a thread has in flight beyond the cache: a ring
// of shared-memory slots, refilled by cp.async as each is summed, so loads
// stay in flight without holding registers (bf16's 8 values a word leave no
// registers for more than 2 rows of x and g in flight). 2, 3, 4, 6 and 8
// slots measured alike on an H100; the reduction area needs 2.
constexpr int kRing = 3;

// One word from global memory into this thread's slot of shared memory:
// asynchronous (cp.async, L1 bypassed) for 16-byte words, else a load and a
// store.
template <typename W>
__device__ __forceinline__ void copy_to_slot(W* dst, const W* src) {
  if constexpr (sizeof(W) == 16) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" :: "r"(d), "l"(src) : "memory");
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most n of this thread's committed cp.async groups are pending
// (a larger n than 15 waits for more than it must, which is safe).
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
#define K3_WAIT(k) case k: asm volatile("cp.async.wait_group " #k ";" ::: "memory"); break;
    K3_WAIT(0) K3_WAIT(1) K3_WAIT(2) K3_WAIT(3) K3_WAIT(4) K3_WAIT(5) K3_WAIT(6) K3_WAIT(7)
    K3_WAIT(8) K3_WAIT(9) K3_WAIT(10) K3_WAIT(11) K3_WAIT(12) K3_WAIT(13) K3_WAIT(14)
#undef K3_WAIT
    default: asm volatile("cp.async.wait_group 15;" ::: "memory");
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
instance_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g,
                         const float* __restrict__ stats, T* __restrict__ dx,
                         float* __restrict__ partial, float* __restrict__ means, Plan p,
                         int relu) {
  using W = Vec<T, V>;
  // Shared memory: kRing ring slots, then cache_iters cache slots. Slot s
  // holds a thread's x word at [2 s kThreads + tid] and its g word kThreads
  // on. The reduction area (V sums of g' and V of g' * xhat a thread) lies
  // over the ring's start: it is written only when every ring is drained.
  extern __shared__ __align__(16) uint8_t smem[];
  float* red_g = reinterpret_cast<float*>(smem);
  float* red_gx = red_g + kThreads * V;
  W* slots = reinterpret_cast<W*>(smem);

  const int tid = threadIdx.x;
  const int lane_p = tid / p.tile, gl = tid % p.tile;
  const int items = p.batch * p.tiles * p.chunks;
  const W* xv = reinterpret_cast<const W*>(x);
  const W* gv = reinterpret_cast<const W*>(g);
  W* dv = reinterpret_cast<W*>(dx);
  auto slot = [&](int s) { return slots + 2LL * s * kThreads + tid; };

  // -- 1. per-chunk sums of g' and g' * xhat -------------------------------
  int it_count = 0;  // loop iterations so far: the cache's slot index
  for (int q = blockIdx.x; q < items; q += gridDim.x) {
    const Item w = item(p, q);
    const int gi = w.g0 + gl;
    const bool active = lane_p < p.pix && gi < p.groups;
    const long long base = static_cast<long long>(w.b) * p.hw * p.groups + gi;
    // this item's first kc iterations go to the cache, the rest through the ring
    const int kc = min(max(p.cache_iters - it_count, 0), w.iters);
    float sg[V], sgx[V], mean[V], rstd[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sg[v] = sgx[v] = 0.f;
      mean[v] = rstd[v] = 0.f;
      if (active) {
        const float* st = stats + 2 * (static_cast<long long>(w.b) * p.c + gi * V + v);
        mean[v] = st[0];
        rstd[v] = st[1];
      }
    }
    auto row = [&](int k) { return w.r0 + lane_p + static_cast<long long>(k) * p.pix; };
    auto slot_of = [&](int k) { return k < kc ? kRing + it_count + k : (k - kc) % kRing; };
    // iteration k's copies, one group
    auto issue = [&](int k) {
      const long long r = row(k);
      if (active && r < w.r1) {
        W* d = slot(slot_of(k));
        copy_to_slot(d, &xv[base + r * p.groups]);
        copy_to_slot(d + kThreads, &gv[base + r * p.groups]);
      }
      cp_async_commit();
    };
    // the cached iterations and the ring's first ones in flight at once; then
    // each ring slot refilled once it is summed
    int issued = 0;
    for (const int pre = min(w.iters, kc + kRing); issued < pre; ++issued) issue(issued);
    for (int k = 0; k < w.iters; ++k) {
      cp_async_wait(issued - 1 - k);
      if (active && row(k) < w.r1) {
        const W* s = slot(slot_of(k));
        const W xw = s[0], gw = s[kThreads];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xh = (to_f(xw.v[v]) - mean[v]) * rstd[v];
          float gg = to_f(gw.v[v]);
          if (relu && !(xh > 0.f)) gg = 0.f;
          sg[v] += gg;
          sgx[v] += gg * xh;
        }
      }
      if (k >= kc && issued < w.iters) issue(issued++);
    }
    it_count += w.iters;
    __syncthreads();  // every thread's ring drained: the reduction area lies over it
#pragma unroll
    for (int v = 0; v < V; ++v) {
      red_g[tid * V + v] = sg[v];
      red_gx[tid * V + v] = sgx[v];
    }
    __syncthreads();
    for (int s = 1; s < p.pix; s *= 2) {
      if (lane_p % (2 * s) == 0 && lane_p + s < p.pix) {
        const int o = tid + s * p.tile;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          red_g[tid * V + v] += red_g[o * V + v];
          red_gx[tid * V + v] += red_gx[o * V + v];
        }
      }
      __syncthreads();
    }
    if (lane_p == 0 && gi < p.groups) {
      const int chunk = q % p.chunks;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float* o = partial + ((static_cast<long long>(w.b) * p.chunks + chunk) * p.c +
                              gi * V + v) * 2;
        o[0] = red_g[tid * V + v];
        o[1] = red_gx[tid * V + v];
      }
    }
    __syncthreads();  // the reduction area, the ring, is refilled by the next item
  }

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  grid.sync();

  // -- 2. one warp per (b, c): the chunks added in a fixed order, a lane's
  //       loads kFin at a time in flight (a (b, c) has up to 132 chunks;
  //       one at a time cost the small slabs 4-5%) --------------------------
  {
    constexpr int kFin = 8;
    const int lane = tid % 32;
    const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
    const float inv_hw = 1.0f / static_cast<float>(p.hw);
    for (long long i = (static_cast<long long>(blockIdx.x) * kThreads + tid) / 32;
         i < static_cast<long long>(p.batch) * p.c; i += warps) {
      const long long b = i / p.c, ch = i % p.c;
      float a = 0.f, ax = 0.f;
      for (int k0 = lane; k0 < p.chunks; k0 += 32 * kFin) {
        float2 v[kFin];
#pragma unroll
        for (int u = 0; u < kFin; ++u) {
          const int k = k0 + 32 * u;
          if (k < p.chunks) {
            v[u] = *reinterpret_cast<const float2*>(partial + ((b * p.chunks + k) * p.c + ch) * 2);
          }
        }
#pragma unroll
        for (int u = 0; u < kFin; ++u) {
          if (k0 + 32 * u < p.chunks) {
            a += v[u].x;
            ax += v[u].y;
          }
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_down_sync(0xffffffffu, a, off);
        ax += __shfl_down_sync(0xffffffffu, ax, off);
      }
      if (lane == 0) {
        means[2 * i] = a * inv_hw;
        means[2 * i + 1] = ax * inv_hw;
      }
    }
  }
  grid.sync();

  // -- 3. dx = rstd * (g' - mean(g') - xhat * mean(g' * xhat)), phase 1's
  //       steps in reverse: items from the last, each one's uncached
  //       iterations from the last down (the t-th is k = iters - 1 - t, in
  //       ring slot t % kRing), then its cached ones
  int last = -1;
  for (int q = blockIdx.x; q < items; q += gridDim.x) last = q;
  for (int q = last; q >= 0; q -= gridDim.x) {
    const Item w = item(p, q);
    it_count -= w.iters;
    const int gi = w.g0 + gl;
    if (!(lane_p < p.pix && gi < p.groups)) continue;
    const long long base = static_cast<long long>(w.b) * p.hw * p.groups + gi;
    const int kc = min(max(p.cache_iters - it_count, 0), w.iters);
    float mean[V], rstd[V], gm[V], gx[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const long long i = static_cast<long long>(w.b) * p.c + gi * V + v;
      mean[v] = stats[2 * i];
      rstd[v] = stats[2 * i + 1];
      gm[v] = means[2 * i];
      gx[v] = means[2 * i + 1];
    }
    auto row = [&](int k) { return w.r0 + lane_p + static_cast<long long>(k) * p.pix; };
    auto put = [&](long long r, const W& xw, const W& gw) {
      float d[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xh = (to_f(xw.v[v]) - mean[v]) * rstd[v];
        float gg = to_f(gw.v[v]);
        if (relu && !(xh > 0.f)) gg = 0.f;
        d[v] = rstd[v] * (gg - gm[v] - xh * gx[v]);
      }
      W o;
      pack(o, d);
      dv[base + r * p.groups] = o;
    };
    const int nu = w.iters - kc;
    auto issue = [&](int t) {
      const long long r = row(w.iters - 1 - t);
      if (r < w.r1) {
        W* d = slot(t % kRing);
        copy_to_slot(d, &xv[base + r * p.groups]);
        copy_to_slot(d + kThreads, &gv[base + r * p.groups]);
      }
      cp_async_commit();
    };
    int issued = 0;
    for (const int pre = min(nu, kRing); issued < pre; ++issued) issue(issued);
    for (int t = 0; t < nu; ++t) {
      cp_async_wait(issued - 1 - t);
      const long long r = row(w.iters - 1 - t);
      if (r < w.r1) {
        const W* s = slot(t % kRing);
        put(r, s[0], s[kThreads]);
      }
      if (issued < nu) issue(issued++);
    }
    for (int k = kc - 1; k >= 0; --k) {
      const long long r = row(k);
      if (r < w.r1) {
        const W* s = slot(kRing + it_count + k);
        put(r, s[0], s[kThreads]);
      }
    }
  }
}

// Dynamic shared memory of one block: all the device lets a block opt in
// to, so one block sits on each SM and caches what it can.
int smem_bytes(int* bytes) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(rc);
}

constexpr int kMaxDevices = 64;

// The most blocks of the kernel resident at once on the current device (its
// SM count x blocks per SM at its shared memory), which is the most a
// cooperative launch takes: instance_norm_kernel<T, V> or
// instance_norm_bwd_kernel<T, V>, each with all the shared memory a block
// may opt in to. Asked once per device and kernel: the launch is on the
// host's critical path at batch 1.
template <typename T, int V, bool kBwd>
int max_blocks(int* blocks) {
  static int known[kMaxDevices] = {};
  int dev = 0, sms = 0, smem = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < kMaxDevices && known[dev] > 0) {
    *blocks = known[dev];
    return 0;
  }
  const void* kernel = kBwd ? reinterpret_cast<const void*>(instance_norm_bwd_kernel<T, V>)
                            : reinterpret_cast<const void*>(instance_norm_kernel<T, V>);
  rc = static_cast<cudaError_t>(smem_bytes(&smem));
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  *blocks = per_sm * sms;
  if (rc == cudaSuccess && dev < kMaxDevices) known[dev] = *blocks;
  return static_cast<int>(rc);
}

template <typename T, int V>
int run(const void* x, const void* res, void* y, float* partial, float* stats, Plan p, int grid,
        int relu, float eps, cudaStream_t s) {
  int smem = 0;  // max_blocks has set the kernel's limit to this
  const int rc = smem_bytes(&smem);
  if (rc != 0) return rc;
  const int red_bytes = kThreads * (1 + 2 * V) * static_cast<int>(sizeof(float));
  p.cache_iters = (smem - red_bytes) / (kThreads * static_cast<int>(sizeof(Vec<T, V>)));
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* yt = static_cast<T*>(y);
  void* args[] = {&xt, &rt, &yt, &partial, &stats, &p, &relu, &eps};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(instance_norm_kernel<T, V>), dim3(grid), dim3(kThreads), args,
      static_cast<size_t>(smem), s));
}

// The backward's cache: slots of one x word and one g word a thread, as many
// as the opt-in shared memory holds after the ring
// (ops/instance_norm.py::bwd_cache_iters). A slot holds 2 kThreads words of
// at least 2 V bytes, the reduction area 2 kThreads V floats, so two ring
// slots cover it.
static_assert(kRing >= 2, "the ring must cover the reduction area");
template <typename T, int V>
int run_bwd(const void* x, const void* g, const float* stats, void* dx, float* partial,
            float* means, Plan p, int grid, int relu, cudaStream_t s) {
  int smem = 0;  // max_blocks has set the kernel's limit to this
  const int rc = smem_bytes(&smem);
  if (rc != 0) return rc;
  p.cache_iters = smem / (kThreads * 2 * static_cast<int>(sizeof(Vec<T, V>))) - kRing;
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dt = static_cast<T*>(dx);
  void* args[] = {&xt, &gt, &stats, &dt, &partial, &means, &p, &relu};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(instance_norm_bwd_kernel<T, V>), dim3(grid), dim3(kThreads),
      args, static_cast<size_t>(smem), s));
}

// The partition of ops/instance_norm.py::plan: slabs are (batch element,
// channel tile); with fewer slabs than blocks each is cut into chunks of
// rows, at most chunk_cap, one block item each.
Plan make_plan(long long hw, int batch, int c, int v, int blocks, int chunk_cap, int* grid) {
  Plan p{};
  p.hw = hw;
  p.batch = batch;
  p.c = c;
  p.groups = c / v;
  p.tile = p.groups < kThreads ? p.groups : kThreads;
  p.tiles = (p.groups + p.tile - 1) / p.tile;
  p.pix = kThreads / p.tile;
  const long long slabs = static_cast<long long>(batch) * p.tiles;
  long long chunks = 1;
  if (slabs < blocks) {
    chunks = blocks / slabs;
    const long long most = (hw + p.pix - 1) / p.pix;
    if (chunks > most) chunks = most;
    if (chunks > chunk_cap) chunks = chunk_cap;
    if (chunks < 1) chunks = 1;  // an empty slab (hw 0): one chunk of no rows
  }
  p.rows_per_chunk = hw > chunks ? (hw + chunks - 1) / chunks : 1;
  p.chunks = hw > 0 ? static_cast<int>((hw + p.rows_per_chunk - 1) / p.rows_per_chunk) : 1;
  const long long items = slabs * p.chunks;
  *grid = static_cast<int>(items < blocks ? items : blocks);
  return p;
}


// -- the partial-statistics form -----------------------------------------------

// The stats and sums launches (see the header): one CTA of kPartThreads
// threads per (slab, chunk) of part_plan.h's partition. A thread owns one
// word (V channels) of the tile and every pix-th row of a stage; a stage
// holds kPartBatch of its words.
static_assert(kPartBatch == kBatch, "a stage is folded in the forward's batches");
constexpr int kPartBars = 128;  // bytes before the ring: its mbarriers
// channels a merging thread holds at the most: a tile's over the CTA's threads
constexpr int kPartMergeChannels = (kPartTileWords * 8 + kPartThreads - 1) / kPartThreads;

// Ring slots: 4 stages of x (64 KiB) for the stats, 3 of x and g (96 KiB)
// for the sums, and two CTAs fit an SM.
#ifndef K3_PART_STATS_STAGES
#define K3_PART_STATS_STAGES 4
#endif
#ifndef K3_PART_SUMS_STAGES
#define K3_PART_SUMS_STAGES 3
#endif
template <int kOps>
__host__ __device__ constexpr int part_stages() {
  return kOps == 1 ? K3_PART_STATS_STAGES : K3_PART_SUMS_STAGES;
}

// The CTA's chunk: CTA q is chunk q % chunks of slab q / chunks = (b, tile).
struct PartItem {
  int b, t, slab, chunk;
  int words;        // the tile's words (its last may be narrower)
  int stages;       // stages of the chunk's rows
  long long r0, r1; // rows [r0, r1)
  long long src;    // word index of (b, r0, the tile's first word)
};

__device__ __forceinline__ PartItem part_item(const PartPlan& p) {
  PartItem it;
  it.chunk = static_cast<int>(blockIdx.x % p.chunks);
  it.slab = static_cast<int>(blockIdx.x / p.chunks);
  it.b = it.slab / p.tiles;
  it.t = it.slab % p.tiles;
  it.words = min(p.tile, p.groups - it.t * p.tile);
  it.r0 = it.chunk * p.rows_per_chunk;
  it.r1 = min(it.r0 + p.rows_per_chunk, p.hw);
  it.stages = it.r1 > it.r0 ? static_cast<int>((it.r1 - it.r0 + p.stage_rows - 1) / p.stage_rows)
                            : 0;
  it.src = (static_cast<long long>(it.b) * p.hw + it.r0) * p.groups +
           static_cast<long long>(it.t) * p.tile;
  return it;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on the mbarrier at bar
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared memory of a stats (kOps 1) or sums (kOps 2) CTA, after kPartBars
// bytes of the ring's barriers: the ring (none on the one-word path), over
// whose start lie the reduction area (the tree's floats, then the merge's
// 3 a thread) and after it the merge's stage of at least kPartStageMin
// bytes.
constexpr int kPartStageMin = 16384;
template <int V, int kOps>
__host__ __device__ constexpr int part_red_bytes() {
  constexpr int words = kOps == 1 ? 1 + 2 * V : 2 * V;
  return kPartThreads * (words > 3 ? words : 3) * static_cast<int>(sizeof(float));
}
template <typename T, int V, int kOps>
__host__ __device__ constexpr int part_smem() {
  constexpr int slot = kPartThreads * kBatch * static_cast<int>(sizeof(Vec<T, V>));
  constexpr int ring = V > 1 ? part_stages<kOps>() * kOps * slot : 0;
  constexpr int merge = part_red_bytes<V, kOps>() + kPartStageMin;
  return kPartBars + (ring > merge ? ring : merge);
}
// The merge's stage: its first float2 and how many it holds.
template <int V, int kOps>
__device__ __forceinline__ float2* part_stage(uint8_t* smem) {
  return reinterpret_cast<float2*>(smem + kPartBars + part_red_bytes<V, kOps>());
}
template <typename T, int V, int kOps>
__host__ __device__ constexpr int part_stage_cap() {
  return (part_smem<T, V, kOps>() - kPartBars - part_red_bytes<V, kOps>()) / 8;
}

// The ring: part_stages<kOps>() slots, each one stage of every operand (x,
// then g for the sums), kPartThreads * kBatch words an operand, row j of
// the stage at word j * words. Where the tile is the whole row (tiles 1)
// a stage's rows are one byte range: thread 0 fills the slot by one
// cp.async.bulk copy an operand, completed on the slot's mbarrier, and the
// CTA meets at a barrier before the slot is refilled. Else each thread
// copies its own words by 16-byte cp.async, one commit group a stage, and
// reads only them: it waits for its own copies and refills its own words,
// with no barrier.
template <typename W, int kOps>
struct Ring {
  static constexpr int kStages = part_stages<kOps>();
  static constexpr int kSlotWords = kPartThreads * kBatch;
  uint64_t* bars;
  W* slots;
  const W* src[kOps];
  bool bulk;

  __device__ const W* stage(int s, int op) const {
    return slots + (s % kStages * kOps + op) * kSlotWords;
  }

  // Stage s of the chunk into its slot: by thread 0 (bulk), else this
  // thread's words of it (lane_p, gl: its pixel lane and word).
  __device__ void issue(const PartPlan& p, const PartItem& it, int s, int lane_p, int gl) const {
    const long long row0 = static_cast<long long>(s) * p.stage_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(p.stage_rows),
                                          it.r1 - it.r0 - row0));
    if (bulk) {
      const uint32_t bar = smem_u32(&bars[s % kStages]);
      const uint32_t bytes = static_cast<uint32_t>(rows * it.words * sizeof(W));
      mbar_expect_tx(bar, bytes * kOps);
#pragma unroll
      for (int op = 0; op < kOps; ++op) {
        bulk_copy(smem_u32(stage(s, op)), src[op] + it.src + row0 * p.groups, bytes, bar);
      }
      return;
    }
    if (gl < it.words) {
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk) {
        const int j = lane_p + kk * p.pix;
        if (lane_p < p.pix && j < rows) {
#pragma unroll
          for (int op = 0; op < kOps; ++op) {
            copy_to_slot(const_cast<W*>(stage(s, op)) + j * it.words + gl,
                         src[op] + it.src + (row0 + j) * p.groups + gl);
          }
        }
      }
    }
    cp_async_commit();
  }

  // The barriers set up (bulk) and the first stages in flight.
  __device__ void start(const PartPlan& p, const PartItem& it, int lane_p, int gl) const {
    const int first = min(kStages, it.stages);
    if (bulk) {
      if (threadIdx.x == 0) {
        for (int i = 0; i < kStages; ++i) mbar_init(smem_u32(&bars[i]), 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < first; ++s) issue(p, it, s, lane_p, gl);
      }
      __syncthreads();
    } else {
      for (int s = 0; s < first; ++s) issue(p, it, s, lane_p, gl);
    }
  }

  // Stage s's words have landed in its slot.
  __device__ void wait(const PartItem& it, int s) const {
    if (bulk) {
      mbar_wait(smem_u32(&bars[s % kStages]), static_cast<uint32_t>((s / kStages) & 1));
    } else {
      cp_async_wait(min(it.stages, s + kStages) - 1 - s);
    }
  }

  // Stage s is folded: its slot takes stage s + kStages.
  __device__ void next(const PartPlan& p, const PartItem& it, int s, int lane_p, int gl) const {
    if (bulk) {
      __syncthreads();
      if (threadIdx.x == 0 && s + kStages < it.stages) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        issue(p, it, s + kStages, lane_p, gl);
      }
    } else if (s + kStages < it.stages) {
      issue(p, it, s + kStages, lane_p, gl);
    }
  }
};

// The CTA's part of a merge is written (by its threads, before the call):
// true in the CTA that takes the counter's last of ``arrivals`` tickets,
// which then reads what the others wrote. That CTA sets the counter back
// to 0 for the next launch. One thread takes the ticket with an
// acquire-release atomic after a barrier that orders the CTA's writes
// before it, as CUTLASS's semaphores do.
__device__ __forceinline__ bool last_of(int* ticket, int arrivals) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int t;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
                 : "=r"(t) : "l"(ticket), "r"(1) : "memory");
    last = t == arrivals - 1;
    if (last) *ticket = 0;
  }
  __syncthreads();
  return last;
}

// The weight nb / n of Chan's merge in the stats launch's trees and merges:
// a fast division (2 ulp at most, the same bits every run) for the IEEE one,
// whose slow path kept the merges from overlapping.
__device__ __forceinline__ float chan_weight(float nb, float n) { return __fdividef(nb, n); }

// Chan's merge of b into a with its weight wb = b.n / n, n = a.n + b.n > 0.
__device__ __forceinline__ Moments merge_weighted(Moments a, Moments b, float n, float wb) {
  const float delta = b.mean - a.mean;
  return {n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

// Two partials in order: the stats' (count, mean, M2) by Chan's merge, the
// sums' (-, sum g', sum g' xhat) added.
template <bool kStats>
__device__ __forceinline__ Moments combine(Moments a, Moments b) {
  if constexpr (kStats) {
    const float n = a.n + b.n;
    return n == 0.f ? a : merge_weighted(a, b, n, chan_weight(b.n, n));
  } else {
    return {0.f, a.mean + b.mean, a.m2 + b.m2};
  }
}

// The slab's result for channel ch0 + cl into out: kStats (count, mean,
// M2), else the two sums.
template <bool kStats>
__device__ __forceinline__ void put_out(float* out, const PartItem& it, const PartPlan& p,
                                        long long ch0, int cl, Moments t) {
  const long long i = static_cast<long long>(it.b) * p.c + ch0 + cl;
  if constexpr (kStats) {
    out[3 * i] = t.n;
    out[3 * i + 1] = t.mean;
    out[3 * i + 2] = t.m2;
  } else {
    out[2 * i] = t.mean;
    out[2 * i + 1] = t.m2;
  }
}

// A slab's chunk partials merged into its result for cs channels from
// shared memory: with cs below kPartThreads the threads go over the
// channels and each channel's chunks are cut into part_runs(cs) contiguous
// runs, each merged in chunk order, then the runs in order (in acc,
// kPartThreads * 3 floats apart from the partials); else each thread takes
// channels tid, tid + kPartThreads, ..., all their chunks in order. The
// stats' count of a chunk is its rows, the same for all its channels: a
// run's count so far is a sum of them (exact in fp32 below 2^24 rows).
template <bool kStats>
struct SlabMerge {
  int runs, cl, run, k0, k1, chunks;
  float unit_rows, last_rows, count;
  Moments t[kPartMergeChannels];

  __device__ SlabMerge(const PartPlan& p, int cs) {
    const int tid = threadIdx.x;
    chunks = p.chunks;
    runs = part_runs(cs);
    cl = runs > 1 ? tid % cs : tid;
    run = runs > 1 ? tid / cs : 0;
    k0 = chunks * run / runs;
    k1 = run < runs ? chunks * (run + 1) / runs : k0;
    unit_rows = static_cast<float>(p.rows_per_chunk);
    last_rows = static_cast<float>(p.hw - (chunks - 1) * p.rows_per_chunk);
    count = 0.f;
#pragma unroll
    for (int j = 0; j < kPartMergeChannels; ++j) t[j] = Moments{0.f, 0.f, 0.f};
  }

  // Chunks [b0, b1) of the slab, chunk k's channel ch at part[(k - b0) cs + ch].
  __device__ void fold(const float2* part, int b0, int b1, int cs) {
    for (int k = max(k0, b0); k < min(k1, b1); ++k) {
      float nb = 0.f, wb = 0.f;
      if constexpr (kStats) {
        nb = k == chunks - 1 ? last_rows : unit_rows;
        count += nb;
        wb = chan_weight(nb, count);
      }
#pragma unroll
      for (int j = 0; j < kPartMergeChannels; ++j) {
        const int ch = cl + j * kPartThreads;
        if (ch < cs) {
          const float2 w = part[(k - b0) * cs + ch];
          if constexpr (kStats) {
            t[j] = merge_weighted(t[j], Moments{nb, w.x, w.y}, count, wb);
          } else {
            t[j] = combine<false>(t[j], Moments{0.f, w.x, w.y});
          }
        }
      }
    }
  }

  // The runs merged in order and the slab's result written (put_out).
  __device__ void finish(float* out, const PartItem& it, const PartPlan& p, long long ch0, int cs,
                         float* acc) {
    if (runs > 1) {
      if (run < runs) {
        acc[3 * (run * cs + cl)] = t[0].n;
        acc[3 * (run * cs + cl) + 1] = t[0].mean;
        acc[3 * (run * cs + cl) + 2] = t[0].m2;
      }
      __syncthreads();
      if (run == 0) {
        Moments m{0.f, 0.f, 0.f};
        for (int r = 0; r < runs; ++r) {
          const float* a = acc + 3 * (r * cs + cl);
          m = combine<kStats>(m, Moments{a[0], a[1], a[2]});
        }
        put_out<kStats>(out, it, p, ch0, cl, m);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPartMergeChannels; ++j) {
        if (cl + j * kPartThreads < cs) put_out<kStats>(out, it, p, ch0, cl + j * kPartThreads, t[j]);
      }
    }
  }
};

// The slab's merge by tickets, after the CTA's chunk partial is written to
// part[(b chunks + chunk) c + ch0 + cl]: the CTA that takes the slab's last
// ticket merges the slab's chunks into out. They come through shared
// memory (stage, cap float2s) in batches: all threads copy a batch by
// 8-byte cp.async, every copy in flight at once and no register held (the
// ticket's acquire has invalidated this SM's L1), then fold it.
template <bool kStats>
__device__ void merge_by_tickets(const PartPlan& p, const PartItem& it, int cs, long long ch0,
                                 const float2* part, int* tickets, float* out, float* acc,
                                 float2* stage, int cap) {
#ifdef K3_PART_DIAG_NOMERGE
  return;
#endif
  if (!last_of(tickets + it.slab, p.chunks)) return;
  const float2* src = part + static_cast<long long>(it.b) * p.chunks * p.c + ch0;
  SlabMerge<kStats> m(p, cs);
  const int tid = threadIdx.x;
  const int batch = cap / cs > 1 ? cap / cs : 1;
  // the copy's threads: rows of cs (or of all threads, where cs is wider),
  // each row taking every rows-th chunk of a batch
  const int width = cs < kPartThreads ? cs : kPartThreads, rows = kPartThreads / width;
  const int copy_row = tid / width, copy_ch = tid % width;
  for (int b0 = 0; b0 < p.chunks; b0 += batch) {
    const int b1 = min(b0 + batch, p.chunks);
    if (b0 > 0) __syncthreads();  // the last batch is folded
    if (copy_row < rows) {
      for (int k = copy_row; k < b1 - b0; k += rows) {
        const float2* from = src + static_cast<long long>(b0 + k) * p.c;
#pragma unroll
        for (int j = 0; j < kPartMergeChannels; ++j) {
          const int ch = copy_ch + j * width;
          if (ch < cs) {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 8;"
                         :: "r"(smem_u32(stage + k * cs + ch)), "l"(from + ch) : "memory");
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    m.fold(stage, b0, b1, cs);
  }
  m.finish(out, it, p, ch0, cs, acc);
}

// This rank's (count, mean, M2) per (b, c) into out[(b c + ch) 3 ...]:
// each thread folds its words of each stage in batches of kBatch (their
// mean and M2 about it, then one Chan merge into its running moments); the
// CTA's pixel lanes merged in a fixed tree into the chunk's (mean, M2) per
// channel, partial[((b chunks + chunk) c + ch) 2 ...] (its count is the
// chunk's rows); then the slab's merge (merge_slab).
template <typename T, int V>
__global__ void __launch_bounds__(kPartThreads, 2)
instance_norm_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                           int* __restrict__ tickets, float* __restrict__ out, PartPlan p) {
  using W = Vec<T, V>;
  constexpr bool kRing = V > 1;
  extern __shared__ __align__(128) uint8_t smem[];
  // the reduction area lies over the ring: written once the ring is drained;
  // channel v of thread tid at [v kPartThreads + tid], so a warp's reads
  // meet no bank conflict
  float* red_n = reinterpret_cast<float*>(smem + kPartBars);
  float* red_mean = red_n + kPartThreads;
  float* red_m2 = red_mean + kPartThreads * V;
  const W* xv = reinterpret_cast<const W*>(x);
  const Ring<W, 1> ring{reinterpret_cast<uint64_t*>(smem),
                        reinterpret_cast<W*>(smem + kPartBars), {xv}, K3_PART_BULK && p.tiles == 1};

  const int tid = threadIdx.x;
  const int lane_p = tid / p.tile, gl = tid % p.tile;
  const PartItem it = part_item(p);
  const bool active = lane_p < p.pix && gl < it.words;
  if constexpr (kRing) ring.start(p, it, lane_p, gl);

  float n = 0.f, mean[V], m2[V];
#pragma unroll
  for (int v = 0; v < V; ++v) mean[v] = m2[v] = 0.f;
  for (int s = 0; s < it.stages; ++s) {
    const long long row0 = static_cast<long long>(s) * p.stage_rows;
    const long long rows = min(static_cast<long long>(p.stage_rows), it.r1 - it.r0 - row0);
    W buf[kBatch];
    int nb = 0;
    if constexpr (kRing) ring.wait(it, s);
#pragma unroll
    for (int kk = 0; kk < kBatch; ++kk) {
      const int j = lane_p + kk * p.pix;
      if (active && j < rows) {
        if constexpr (kRing) {
          buf[kk] = ring.stage(s, 0)[j * it.words + gl];
        } else {
          buf[kk] = xv[it.src + (row0 + j) * p.groups + gl];
        }
        ++nb;
      }
    }
    if (nb > 0) {
      const float nbf = static_cast<float>(nb), inv = 1.f / nbf;
      const float n_new = n + nbf, f = nbf / n_new;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float sum = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBatch; ++kk) if (kk < nb) sum += to_f(buf[kk].v[v]);
        const float mb = sum * inv;
        float q2 = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBatch; ++kk) {
          if (kk < nb) {
            const float d = to_f(buf[kk].v[v]) - mb;
            q2 += d * d;
          }
        }
        const float delta = mb - mean[v];
        mean[v] += delta * f;
        m2[v] += q2 + delta * delta * n * f;
      }
      n = n_new;
    }
    if constexpr (kRing) ring.next(p, it, s, lane_p, gl);
  }
  __syncthreads();  // the ring drained: the reduction area lies over it

  red_n[tid] = n;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    red_mean[v * kPartThreads + tid] = mean[v];
    red_m2[v * kPartThreads + tid] = m2[v];
  }
  __syncthreads();
  for (int s = 1; s < p.pix; s *= 2) {
    if (lane_p % (2 * s) == 0 && lane_p + s < p.pix) {
      const int o = tid + s * p.tile;
      const float na = red_n[tid], nb = red_n[o];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const Moments m = combine<true>(
            {na, red_mean[v * kPartThreads + tid], red_m2[v * kPartThreads + tid]},
            {nb, red_mean[v * kPartThreads + o], red_m2[v * kPartThreads + o]});
        red_mean[v * kPartThreads + tid] = m.mean;
        red_m2[v * kPartThreads + tid] = m.m2;
      }
      red_n[tid] = na + nb;
    }
    __syncthreads();
  }
  const long long ch0 = static_cast<long long>(it.t) * p.tile * V;  // the tile's first channel
  float2* part = reinterpret_cast<float2*>(partial);
  if (lane_p == 0 && gl < it.words) {
    float2* o = part + (static_cast<long long>(it.b) * p.chunks + it.chunk) * p.c + ch0 + gl * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const Moments m{red_n[tid], red_mean[v * kPartThreads + tid], red_m2[v * kPartThreads + tid]};
      if (p.chunks == 1) {  // a slab of one chunk: the tree's result is the slab's
        put_out<true>(out, it, p, ch0, gl * V + v, m);
      } else {
        o[v] = make_float2(m.mean, m.m2);
      }
    }
  }
  if (p.chunks > 1) {
    merge_by_tickets<true>(p, it, it.words * V, ch0, part, tickets, out, red_n,
                           part_stage<V, 1>(smem), part_stage_cap<T, V, 1>());
  }
}

// This rank's fp32 sums of g' and g' * xhat per (b, c) into out[(b c + ch)
// 2 ...] (sums, not means: the host adds the ranks' before dividing): each
// thread sums its words of each stage of x and g; the CTA's pixel lanes
// added in a fixed tree into the chunk's partial[((b chunks + chunk) c +
// ch) 2 ...]; then the slab's merge (merge_slab).
template <typename T, int V>
__global__ void __launch_bounds__(kPartThreads, 2)
instance_norm_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                              const float* __restrict__ ms, float* __restrict__ partial,
                              int* __restrict__ tickets, float* __restrict__ out, PartPlan p,
                              int relu) {
  using W = Vec<T, V>;
  constexpr bool kRing = V > 1;
  extern __shared__ __align__(128) uint8_t smem[];
  float* red_g = reinterpret_cast<float*>(smem + kPartBars);  // over the drained ring
  float* red_gx = red_g + kPartThreads * V;
  const W* xv = reinterpret_cast<const W*>(x);
  const W* gv = reinterpret_cast<const W*>(g);
  const Ring<W, 2> ring{reinterpret_cast<uint64_t*>(smem),
                        reinterpret_cast<W*>(smem + kPartBars), {xv, gv},
                        K3_PART_BULK && p.tiles == 1};

  const int tid = threadIdx.x;
  const int lane_p = tid / p.tile, gl = tid % p.tile;
  const PartItem it = part_item(p);
  const bool active = lane_p < p.pix && gl < it.words;
  const long long ch0 = static_cast<long long>(it.t) * p.tile * V;
  if constexpr (kRing) ring.start(p, it, lane_p, gl);

  float sg[V], sgx[V], mean[V], rstd[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sg[v] = sgx[v] = mean[v] = rstd[v] = 0.f;
    if (active) {
      const float* st = ms + 2 * (static_cast<long long>(it.b) * p.c + ch0 + gl * V + v);
      mean[v] = st[0];
      rstd[v] = st[1];
    }
  }
  for (int s = 0; s < it.stages; ++s) {
    const long long row0 = static_cast<long long>(s) * p.stage_rows;
    const long long rows = min(static_cast<long long>(p.stage_rows), it.r1 - it.r0 - row0);
    if constexpr (kRing) ring.wait(it, s);
#pragma unroll
    for (int kk = 0; kk < kBatch; ++kk) {
      const int j = lane_p + kk * p.pix;
      if (active && j < rows) {
        W xw, gw;
        if constexpr (kRing) {
          xw = ring.stage(s, 0)[j * it.words + gl];
          gw = ring.stage(s, 1)[j * it.words + gl];
        } else {
          xw = xv[it.src + (row0 + j) * p.groups + gl];
          gw = gv[it.src + (row0 + j) * p.groups + gl];
        }
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xh = (to_f(xw.v[v]) - mean[v]) * rstd[v];
          float gg = to_f(gw.v[v]);
          if (relu && !(xh > 0.f)) gg = 0.f;
          sg[v] += gg;
          sgx[v] += gg * xh;
        }
      }
    }
    if constexpr (kRing) ring.next(p, it, s, lane_p, gl);
  }
  __syncthreads();  // the ring drained: the reduction area lies over it

#pragma unroll
  for (int v = 0; v < V; ++v) {
    red_g[v * kPartThreads + tid] = sg[v];
    red_gx[v * kPartThreads + tid] = sgx[v];
  }
  __syncthreads();
  for (int s = 1; s < p.pix; s *= 2) {
    if (lane_p % (2 * s) == 0 && lane_p + s < p.pix) {
      const int o = tid + s * p.tile;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        red_g[v * kPartThreads + tid] += red_g[v * kPartThreads + o];
        red_gx[v * kPartThreads + tid] += red_gx[v * kPartThreads + o];
      }
    }
    __syncthreads();
  }
  float2* part = reinterpret_cast<float2*>(partial);
  if (lane_p == 0 && gl < it.words) {
    float2* o = part + (static_cast<long long>(it.b) * p.chunks + it.chunk) * p.c + ch0 + gl * V;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const Moments m{0.f, red_g[v * kPartThreads + tid], red_gx[v * kPartThreads + tid]};
      if (p.chunks == 1) {  // a slab of one chunk: the tree's result is the slab's
        put_out<false>(out, it, p, ch0, gl * V + v, m);
      } else {
        o[v] = make_float2(m.mean, m.m2);
      }
    }
  }
  if (p.chunks > 1) {
    merge_by_tickets<false>(p, it, it.words * V, ch0, part, tickets, out, red_g,
                            part_stage<V, 2>(smem), part_stage_cap<T, V, 2>());
  }
}

// The apply and dx launches (see the header): one CTA of kApplyThreads
// threads per (slab, chunk) of part_plan.h's apply partition. A thread owns
// one word (V channels) of the tile and every pix-th row of each step.
constexpr int kApplyMaxChannels = kApplyTileWords * 8;  // a tile's channels, at the most
// channels a thread merges, at the most
constexpr int kApplyMergeSlots = (kApplyMaxChannels + kApplyThreads - 1) / kApplyThreads;
constexpr int kApplyRanks = 4;  // ranks' parts a thread has in flight at once

// Rows a thread loads a step: the plan's kApplyBatch, and half of it for
// the dx on bf16 words, whose four statistics of 8 channels a word leave
// the registers of two CTAs an SM for fewer loads (an H100 ran it faster).
template <int V, bool kDx>
__host__ __device__ constexpr int apply_batch() {
  return kDx && V > 4 && kApplyBatch > 1 ? kApplyBatch / 2 : kApplyBatch;
}

// A step's words of one operand, B rows of this thread's word.
template <typename W, int B>
struct Rows {
  W w[B];
};

// Rows r + lane_p + kk pix (kk < B) below r1 of the operand at src (word
// base + row * groups): every load issued before any is used; a row past
// r1, or an idle thread's, is not read.
template <typename W, int B>
__device__ __forceinline__ void load_rows(Rows<W, B>& o, const W* __restrict__ src,
                                          long long base, const ApplyPlan& p, long long r,
                                          long long r1, int lane_p, bool active) {
#pragma unroll
  for (int kk = 0; kk < B; ++kk) {
    const long long row = r + lane_p + static_cast<long long>(kk) * p.pix;
    if (active && row < r1) o.w[kk] = src[base + row * p.groups];
  }
}

// The apply's statistics of the CTA's tile, once a CTA: thread tid merges
// channels tid, tid + kApplyThreads, ... of the tile, the S ranks' (count,
// mean, M2) in rank order with merge, every rank's loads of a batch of
// kApplyRanks issued before the first fold; mean and rstd into st. The
// slab's first chunk writes them to ms for the backward.
template <int V>
__device__ __forceinline__ void apply_stats(float2* st, const float* __restrict__ parts,
                                            float* __restrict__ ms, const ApplyPlan& p,
                                            const ApplyItem& it, int n_parts, float eps) {
  const int cs = it.words * V;
  const long long ch0 = static_cast<long long>(it.t) * p.tile * V;
  const long long stride = 3LL * p.batch * p.c;  // one rank's parts
  Moments t[kApplyMergeSlots];
#pragma unroll
  for (int j = 0; j < kApplyMergeSlots; ++j) t[j] = Moments{0.f, 0.f, 0.f};
  for (int s0 = 0; s0 < n_parts; s0 += kApplyRanks) {
    float q[kApplyMergeSlots][kApplyRanks][3];
#pragma unroll
    for (int j = 0; j < kApplyMergeSlots; ++j) {
      const int cl = threadIdx.x + j * kApplyThreads;
#pragma unroll
      for (int k = 0; k < kApplyRanks; ++k) {
        if (cl < cs && s0 + k < n_parts) {
          const float* o = parts + (s0 + k) * stride + 3 * (static_cast<long long>(it.b) * p.c +
                                                             ch0 + cl);
          q[j][k][0] = o[0];
          q[j][k][1] = o[1];
          q[j][k][2] = o[2];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kApplyMergeSlots; ++j) {
#pragma unroll
      for (int k = 0; k < kApplyRanks; ++k) {
        if (s0 + k < n_parts) t[j] = merge(t[j], Moments{q[j][k][0], q[j][k][1], q[j][k][2]});
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kApplyMergeSlots; ++j) {
    const int cl = threadIdx.x + j * kApplyThreads;
    if (cl < cs) {
      const float2 m = make_float2(t[j].mean, 1.0f / sqrtf(t[j].m2 / t[j].n + eps));
      st[cl] = m;
      if (it.chunk == 0) {
        reinterpret_cast<float2*>(ms)[static_cast<long long>(it.b) * p.c + ch0 + cl] = m;
      }
    }
  }
}

// parts: the S ranks' (count, mean, M2), (S, batch, c, 3), merged in rank
// order once a CTA (apply_stats); ms: (batch, c, 2) mean and rstd, written
// by each slab's first CTA for the backward. The CTA's first step of x (and
// of the residual) is in flight while it merges; each step's loads are all
// issued before its rows are normalized and stored.
template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads, kApplyMinBlocks)
instance_norm_apply_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                           const float* __restrict__ parts, float* __restrict__ ms, ApplyPlan p,
                           int n_parts, int relu, float eps) {
  using W = Vec<T, V>;
  constexpr int B = apply_batch<V, false>();
  __shared__ float2 st[kApplyMaxChannels];
  const ApplyItem it = apply_item(p, blockIdx.x);
  const int tid = threadIdx.x;
  const int lane_p = tid / p.tile, gl = tid % p.tile;
  const bool active = lane_p < p.pix && gl < it.words;
  const W* xv = reinterpret_cast<const W*>(x);
  const W* rv = reinterpret_cast<const W*>(res);
  W* yv = reinterpret_cast<W*>(y);
  const long long base = static_cast<long long>(it.b) * p.hw * p.groups +
                         static_cast<long long>(it.t) * p.tile + gl;
  Rows<W, B> xb, rb;
  load_rows(xb, xv, base, p, it.r0, it.r1, lane_p, active);
  if (res != nullptr) load_rows(rb, rv, base, p, it.r0, it.r1, lane_p, active);
  apply_stats<V>(st, parts, ms, p, it, n_parts, eps);
  __syncthreads();
  float mean[V], rstd[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float2 m = active ? st[gl * V + v] : make_float2(0.f, 0.f);
    mean[v] = m.x;
    rstd[v] = m.y;
  }
  for (long long r = it.r0; r < it.r1; r += B * p.pix) {
    if (r > it.r0) {
      load_rows(xb, xv, base, p, r, it.r1, lane_p, active);
      if (res != nullptr) load_rows(rb, rv, base, p, r, it.r1, lane_p, active);
    }
#pragma unroll
    for (int kk = 0; kk < B; ++kk) {
      const long long row = r + lane_p + static_cast<long long>(kk) * p.pix;
      if (active && row < it.r1) {
        float f[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float t = (to_f(xb.w[kk].v[v]) - mean[v]) * rstd[v];
          if (relu) t = fmaxf(t, 0.f);
          if (res != nullptr) t += to_f(rb.w[kk].v[v]);
          f[v] = t;
        }
        W o;
        pack(o, f);
        yv[base + row * p.groups] = o;
      }
    }
  }
}

// parts: the S ranks' sums (S, batch, c, 2), added in rank order and divided
// by the global count once a CTA, with the forward's mean and rstd (ms),
// into shared memory; dx = rstd (g' - mean(g') - xhat mean(g' xhat)). The
// loads as the apply's. A CTA of an empty slab writes nothing.
template <typename T, int V>
__global__ void __launch_bounds__(kApplyThreads, kApplyMinBlocks)
instance_norm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            const float* __restrict__ ms, const float* __restrict__ parts,
                            T* __restrict__ dx, ApplyPlan p, int n_parts, int relu,
                            float count) {
  using W = Vec<T, V>;
  constexpr int B = apply_batch<V, true>();
  __shared__ float4 st[kApplyMaxChannels];  // mean, rstd, mean(g'), mean(g' xhat)
  const ApplyItem it = apply_item(p, blockIdx.x);
  if (it.r1 <= it.r0) return;
  const int tid = threadIdx.x;
  const int lane_p = tid / p.tile, gl = tid % p.tile;
  const bool active = lane_p < p.pix && gl < it.words;
  const W* xv = reinterpret_cast<const W*>(x);
  const W* gv = reinterpret_cast<const W*>(g);
  W* dv = reinterpret_cast<W*>(dx);
  const long long base = static_cast<long long>(it.b) * p.hw * p.groups +
                         static_cast<long long>(it.t) * p.tile + gl;
  Rows<W, B> xb, gb;
  load_rows(xb, xv, base, p, it.r0, it.r1, lane_p, active);
  load_rows(gb, gv, base, p, it.r0, it.r1, lane_p, active);
  {
    const int cs = it.words * V;
    const long long ch0 = static_cast<long long>(it.t) * p.tile * V;
    const long long stride = 2LL * p.batch * p.c;  // one rank's sums
#pragma unroll
    for (int j = 0; j < kApplyMergeSlots; ++j) {
      const int cl = tid + j * kApplyThreads;
      if (cl < cs) {
        const long long i = static_cast<long long>(it.b) * p.c + ch0 + cl;
        const float2 m = reinterpret_cast<const float2*>(ms)[i];
        float a = 0.f, ax = 0.f;
        for (int s0 = 0; s0 < n_parts; s0 += kApplyRanks) {
          float2 q[kApplyRanks];
#pragma unroll
          for (int k = 0; k < kApplyRanks; ++k) {
            if (s0 + k < n_parts) q[k] = reinterpret_cast<const float2*>(parts + (s0 + k) * stride)[i];
          }
#pragma unroll
          for (int k = 0; k < kApplyRanks; ++k) {
            if (s0 + k < n_parts) {
              a += q[k].x;
              ax += q[k].y;
            }
          }
        }
        st[cl] = make_float4(m.x, m.y, a / count, ax / count);
      }
    }
  }
  __syncthreads();
  float mean[V], rstd[V], gm[V], gx[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float4 m = active ? st[gl * V + v] : make_float4(0.f, 0.f, 0.f, 0.f);
    mean[v] = m.x;
    rstd[v] = m.y;
    gm[v] = m.z;
    gx[v] = m.w;
  }
  for (long long r = it.r0; r < it.r1; r += B * p.pix) {
    if (r > it.r0) {
      load_rows(xb, xv, base, p, r, it.r1, lane_p, active);
      load_rows(gb, gv, base, p, r, it.r1, lane_p, active);
    }
#pragma unroll
    for (int kk = 0; kk < B; ++kk) {
      const long long row = r + lane_p + static_cast<long long>(kk) * p.pix;
      if (active && row < it.r1) {
        float d[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float xh = (to_f(xb.w[kk].v[v]) - mean[v]) * rstd[v];
          float gg = to_f(gb.w[kk].v[v]);
          if (relu && !(xh > 0.f)) gg = 0.f;
          d[v] = rstd[v] * (gg - gm[v] - xh * gx[v]);
        }
        W o;
        pack(o, d);
        dv[base + row * p.groups] = o;
      }
    }
  }
}

// The kernel's limit of dynamic shared memory raised to smem bytes, once
// per device (above 48 KiB a launch needs it).
template <const void* (*Kernel)()>
int allow_smem(int smem) {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < kMaxDevices && done[dev]) return 0;
  rc = cudaFuncSetAttribute(Kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return static_cast<int>(rc);
}

template <typename T, int V>
const void* stats_kernel() {
  return reinterpret_cast<const void*>(instance_norm_stats_kernel<T, V>);
}
template <typename T, int V>
const void* sums_kernel() {
  return reinterpret_cast<const void*>(instance_norm_bwd_sums_kernel<T, V>);
}

// One launch of the stats or sums kernel on the plan's grid.
template <typename... Params, typename... Args>
int launch_part(void (*kernel)(Params...), const PartPlan& p, int smem, cudaStream_t s,
                Args... args) {
  const long long n = static_cast<long long>(p.batch) * p.tiles * p.chunks;
  if (n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(n), kPartThreads, smem, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int run_stats(const void* x, float* partial, int* tickets, float* out, long long hw, int batch,
              int c, cudaStream_t s) {
  const PartPlan p = make_part_plan(hw, batch, c, V);
  constexpr int smem = part_smem<T, V, 1>();
  const int rc = allow_smem<stats_kernel<T, V>>(smem);
  if (rc != 0) return rc;
  return launch_part(instance_norm_stats_kernel<T, V>, p, smem, s, static_cast<const T*>(x),
                     partial, tickets, out, p);
}

template <typename T, int V>
int run_sums(const void* x, const void* g, const float* ms, float* partial, int* tickets,
             float* out, long long hw, int batch, int c, int relu, cudaStream_t s) {
  const PartPlan p = make_part_plan(hw, batch, c, V);
  constexpr int smem = part_smem<T, V, 2>();
  const int rc = allow_smem<sums_kernel<T, V>>(smem);
  if (rc != 0) return rc;
  return launch_part(instance_norm_bwd_sums_kernel<T, V>, p, smem, s, static_cast<const T*>(x),
                     static_cast<const T*>(g), ms, partial, tickets, out, p, relu);
}

// One launch of the apply or dx kernel on part_plan.h's apply partition.
template <typename... Params, typename... Args>
int launch_apply(void (*kernel)(Params...), const ApplyPlan& p, cudaStream_t s, Args... args) {
  const long long n = static_cast<long long>(p.batch) * p.tiles * p.chunks;
  if (n < 1 || n > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<static_cast<unsigned>(n), kApplyThreads, 0, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int run_apply(const void* x, const void* res, void* y, const float* parts, float* ms,
              long long hw, int batch, int c, int n_parts, int relu, float eps, cudaStream_t s) {
  const ApplyPlan p = make_apply_plan(hw, batch, c, V);
  return launch_apply(instance_norm_apply_kernel<T, V>, p, s, static_cast<const T*>(x),
                      static_cast<const T*>(res), static_cast<T*>(y), parts, ms, p, n_parts,
                      relu, eps);
}

template <typename T, int V>
int run_dx(const void* x, const void* g, const float* ms, const float* parts, void* dx,
           long long hw, int batch, int c, int n_parts, int relu, float count, cudaStream_t s) {
  const ApplyPlan p = make_apply_plan(hw, batch, c, V);
  return launch_apply(instance_norm_bwd_dx_kernel<T, V>, p, s, static_cast<const T*>(x),
                      static_cast<const T*>(g), ms, parts, static_cast<T*>(dx), p, n_parts, relu,
                      count);
}

// One of the four templates at the operand's type and word width.
#define K3_DISPATCH(fn, ...)                                                   \
  (elt_size == 2 ? (vec ? fn<bf16, 8>(__VA_ARGS__) : fn<bf16, 1>(__VA_ARGS__)) \
                 : (vec ? fn<float, 4>(__VA_ARGS__) : fn<float, 1>(__VA_ARGS__)))

// The partial form takes a rank's slab of no rows (hw 0): its stats and sums
// are the (0, 0, 0) and (0, 0) parts, its apply writes the merged mean and
// rstd, its dx nothing.
bool bad_operands(long long hw, int batch, int c, int vec, int elt_size) {
  const int v = vec ? 16 / (elt_size > 0 ? elt_size : 1) : 1;
  return batch < 1 || hw < 0 || c < 1 || c % v || (elt_size != 2 && elt_size != 4);
}

}  // namespace

// x, res (nullable), y: (batch, hw, c) contiguous, of one type (elt_size 2:
// bf16, 4: fp32), 16-byte aligned when vec is 1 (then c is a multiple of 8
// for bf16, 4 for fp32). partial: fp32 workspace of batch * chunk_cap * c *
// 3, chunk_cap = ops/instance_norm.py::max_chunks; stats: fp32 workspace of
// batch * c * 2; all allocated by the caller. One cooperative launch of as
// many blocks as the device holds at once. Returns a cudaError_t: 0 when it
// was accepted.
extern "C" int instance_norm_launch(const void* x, const void* res, void* y, void* partial,
                                    void* stats, long long hw, int batch, int c, int chunk_cap,
                                    int relu, int vec, int elt_size, float eps, void* stream) {
  const int v = vec ? 16 / (elt_size > 0 ? elt_size : 1) : 1;
  if (batch < 1 || hw < 1 || c < 1 || chunk_cap < 1 || c % v ||
      (elt_size != 2 && elt_size != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const int rc = elt_size == 2 ? (vec ? max_blocks<bf16, 8, false>(&blocks) : max_blocks<bf16, 1, false>(&blocks))
                               : (vec ? max_blocks<float, 4, false>(&blocks) : max_blocks<float, 1, false>(&blocks));
  if (rc != 0) return rc;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = 0;
  Plan p = make_plan(hw, batch, c, v, blocks, chunk_cap, &grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  if (elt_size == 2) {
    return vec ? run<bf16, 8>(x, res, y, pt, st, p, grid, relu, eps, s)
               : run<bf16, 1>(x, res, y, pt, st, p, grid, relu, eps, s);
  }
  return vec ? run<float, 4>(x, res, y, pt, st, p, grid, relu, eps, s)
             : run<float, 1>(x, res, y, pt, st, p, grid, relu, eps, s);
}

// The backward of instance_norm_launch. x, g (the output's gradient), dx:
// (batch, hw, c) contiguous, of one type (elt_size 2: bf16, 4: fp32), 16-byte
// aligned when vec is 1; stats: the forward's (batch, c, 2) fp32 mean and
// rstd; partial: fp32 workspace of batch * chunk_cap * c * 2; means: fp32
// workspace of batch * c * 2; all allocated by the caller. One cooperative
// launch of as many blocks as the device holds at once, each with all the
// shared memory it may opt in to. Returns a cudaError_t: 0 when it was
// accepted.
extern "C" int instance_norm_bwd_launch(const void* x, const void* g, const void* stats, void* dx,
                                        void* partial, void* means, long long hw, int batch,
                                        int c, int chunk_cap, int relu, int vec, int elt_size,
                                        void* stream) {
  const int v = vec ? 16 / (elt_size > 0 ? elt_size : 1) : 1;
  if (batch < 1 || hw < 1 || c < 1 || chunk_cap < 1 || c % v ||
      (elt_size != 2 && elt_size != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const int rc = elt_size == 2
                     ? (vec ? max_blocks<bf16, 8, true>(&blocks) : max_blocks<bf16, 1, true>(&blocks))
                     : (vec ? max_blocks<float, 4, true>(&blocks)
                            : max_blocks<float, 1, true>(&blocks));
  if (rc != 0) return rc;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = 0;
  Plan p = make_plan(hw, batch, c, v, blocks, chunk_cap, &grid);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* st = static_cast<const float*>(stats);
  float* pt = static_cast<float*>(partial);
  float* mt = static_cast<float*>(means);
  if (elt_size == 2) {
    return vec ? run_bwd<bf16, 8>(x, g, st, dx, pt, mt, p, grid, relu, s)
               : run_bwd<bf16, 1>(x, g, st, dx, pt, mt, p, grid, relu, s);
  }
  return vec ? run_bwd<float, 4>(x, g, st, dx, pt, mt, p, grid, relu, s)
             : run_bwd<float, 1>(x, g, st, dx, pt, mt, p, grid, relu, s);
}

// The partial-statistics form's launchers (see the header). x, res
// (nullable), y, g, dx: (batch, hw, c) contiguous, of one type (elt_size 2:
// bf16, 4: fp32), 16-byte aligned when vec is 1; every workspace fp32,
// allocated by the caller. Each returns a cudaError_t: 0 when the launch
// was accepted.

// out: (batch, c, 3) this rank's count, mean and M2; partial and tickets:
// the fp32 workspace and the int counters that instance_norm_part_plan
// (part_plan.h) gives for the same operands, vec's channels a word; the
// counters 0 before the launch and after it.
extern "C" int instance_norm_stats_launch(const void* x, void* partial, void* tickets, void* out,
                                          long long hw, int batch, int c, int vec, int elt_size,
                                          void* stream) {
  if (bad_operands(hw, batch, c, vec, elt_size)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  int* tt = static_cast<int*>(tickets);
  float* ot = static_cast<float*>(out);
  return K3_DISPATCH(run_stats, x, pt, tt, ot, hw, batch, c, s);
}

// parts: (n_parts, batch, c, 3) the ranks' count, mean and M2 in rank order;
// ms: (batch, c, 2) the merged mean and rstd, for the backward.
extern "C" int instance_norm_apply_launch(const void* x, const void* res, void* y,
                                          const void* parts, void* ms, long long hw, int batch,
                                          int c, int n_parts, int relu, int vec, int elt_size,
                                          float eps, void* stream) {
  if (bad_operands(hw, batch, c, vec, elt_size) || n_parts < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pt = static_cast<const float*>(parts);
  float* mt = static_cast<float*>(ms);
  return K3_DISPATCH(run_apply, x, res, y, pt, mt, hw, batch, c, n_parts, relu, eps, s);
}

// ms: the forward's (batch, c, 2) mean and rstd; out: (batch, c, 2) this
// rank's sums of g' and g' * xhat; partial and tickets as for the stats
// launch.
extern "C" int instance_norm_bwd_sums_launch(const void* x, const void* g, const void* ms,
                                             void* partial, void* tickets, void* out, long long hw,
                                             int batch, int c, int relu, int vec, int elt_size,
                                             void* stream) {
  if (bad_operands(hw, batch, c, vec, elt_size)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mt = static_cast<const float*>(ms);
  float* pt = static_cast<float*>(partial);
  int* tt = static_cast<int*>(tickets);
  float* ot = static_cast<float*>(out);
  return K3_DISPATCH(run_sums, x, g, mt, pt, tt, ot, hw, batch, c, relu, s);
}

// parts: (n_parts, batch, c, 2) the ranks' sums in rank order; count: the
// global slab's pixels.
extern "C" int instance_norm_bwd_dx_launch(const void* x, const void* g, const void* ms,
                                           const void* parts, void* dx, long long hw, int batch,
                                           int c, int n_parts, int relu, int vec, int elt_size,
                                           float count, void* stream) {
  if (bad_operands(hw, batch, c, vec, elt_size) || n_parts < 1 || !(count > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mt = static_cast<const float*>(ms);
  const float* pt = static_cast<const float*>(parts);
  return K3_DISPATCH(run_dx, x, g, mt, pt, dx, hw, batch, c, n_parts, relu, count, s);
}
