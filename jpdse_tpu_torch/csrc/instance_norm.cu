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
//   forward: instance_norm_stats_kernel (cooperative: the forward's phase 1
//     without its shared-memory cache, a grid barrier, then one warp per
//     (b, c) merging the chunks in a fixed order into this rank's
//     (count, mean, M2)); the host gathers the S ranks' triples;
//     instance_norm_apply_kernel (an ordinary launch of one block per chunk
//     of rows: each thread merges the S triples of its channels in rank
//     order, so every rank holds the same bits, then normalizes its rows,
//     ReLU, the fp32 residual, one cast; x is read a second time);
//   backward: instance_norm_bwd_sums_kernel (cooperative: the fp32 sums of
//     g' and g' * xhat per (b, c), sums, not means); the host gathers them;
//     instance_norm_bwd_dx_kernel (each thread adds the S ranks' sums in
//     rank order, divides by the global count, computes dx).
// Bound: bytes. Forward, two reads of x and one write of y; backward, two
// reads each of x and g and one write of dx.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// Phases 1-2 of the forward, without its cache: this rank's (count, mean,
// M2) per (b, c) into out[(b c + ch) 3 ...].
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
instance_norm_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                           float* __restrict__ out, Plan p) {
  using W = Vec<T, V>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* red_n = reinterpret_cast<float*>(smem);
  float* red_mean = red_n + kThreads;
  float* red_m2 = red_mean + kThreads * V;

  const int tid = threadIdx.x;
  const int lane_p = tid / p.tile, gl = tid % p.tile;
  const int items = p.batch * p.tiles * p.chunks;
  const W* xv = reinterpret_cast<const W*>(x);

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
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk) {
        const long long r = w.r0 + lane_p + static_cast<long long>(k0 + kk) * p.pix;
        if (active && k0 + kk < w.iters && r < w.r1) {
          buf[kk] = xv[base + r * p.groups];
          ++nb;
        }
      }
      if (nb == 0) continue;
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
    __syncthreads();
  }

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  grid.sync();

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
      out[3 * i] = t.n;
      out[3 * i + 1] = t.mean;
      out[3 * i + 2] = t.m2;
    }
  }
}

// The apply and dx launches' partition (ops/instance_norm.py::apply_plan):
// one block per chunk of kApplyIters loop iterations of one (b, channel
// tile) slab, blocks in (b, tile, chunk) order.
constexpr int kApplyIters = 8;

struct ApplyPlan {
  long long hw, rows_per_chunk;
  int batch, c, chunks, groups, tile, tiles, pix, parts;
};

ApplyPlan make_apply_plan(long long hw, int batch, int c, int v, int parts, long long* grid) {
  ApplyPlan p{};
  p.hw = hw;
  p.batch = batch;
  p.c = c;
  p.parts = parts;
  p.groups = c / v;
  p.tile = p.groups < kThreads ? p.groups : kThreads;
  p.tiles = (p.groups + p.tile - 1) / p.tile;
  p.pix = kThreads / p.tile;
  p.rows_per_chunk = static_cast<long long>(p.pix) * kApplyIters;
  // an empty slab (hw 0) keeps one chunk: its blocks write the merged mean and rstd
  p.chunks = hw > 0 ? static_cast<int>((hw + p.rows_per_chunk - 1) / p.rows_per_chunk) : 1;
  *grid = static_cast<long long>(batch) * p.tiles * p.chunks;
  return p;
}

// parts: the S ranks' (count, mean, M2), (S, batch, c, 3), merged in rank
// order; ms: (batch, c, 2) mean and rstd, written by the first chunk's
// blocks for the backward.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
instance_norm_apply_kernel(const T* __restrict__ x, const T* __restrict__ res, T* __restrict__ y,
                           const float* __restrict__ parts, float* __restrict__ ms, ApplyPlan p,
                           int relu, float eps) {
  using W = Vec<T, V>;
  const int tid = threadIdx.x;
  const int lane_p = tid / p.tile, gl = tid % p.tile;
  const long long q = blockIdx.x;
  const int chunk = static_cast<int>(q % p.chunks);
  const long long slab = q / p.chunks;
  const int b = static_cast<int>(slab / p.tiles), tile = static_cast<int>(slab % p.tiles);
  const int g = tile * p.tile + gl;
  if (lane_p >= p.pix || g >= p.groups) return;
  float mean[V], rstd[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    Moments t{0.f, 0.f, 0.f};
    for (int s = 0; s < p.parts; ++s) {
      const float* o = parts + ((static_cast<long long>(s) * p.batch + b) * p.c + g * V + v) * 3;
      t = merge(t, Moments{o[0], o[1], o[2]});
    }
    mean[v] = t.mean;
    rstd[v] = 1.0f / sqrtf(t.m2 / t.n + eps);
    if (chunk == 0 && lane_p == 0) {
      float* m = ms + 2 * (static_cast<long long>(b) * p.c + g * V + v);
      m[0] = mean[v];
      m[1] = rstd[v];
    }
  }
  const W* xv = reinterpret_cast<const W*>(x);
  const W* rv = reinterpret_cast<const W*>(res);
  W* yv = reinterpret_cast<W*>(y);
  const long long base = static_cast<long long>(b) * p.hw * p.groups + g;
  const long long r0 = chunk * p.rows_per_chunk;
  const long long r1 = min(r0 + p.rows_per_chunk, p.hw);
#pragma unroll 4
  for (int k = 0; k < kApplyIters; ++k) {
    const long long r = r0 + lane_p + static_cast<long long>(k) * p.pix;
    if (r >= r1) break;
    const W xw = xv[base + r * p.groups];
    W rw;
    if (res != nullptr) rw = rv[base + r * p.groups];
    float f[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float t = (to_f(xw.v[v]) - mean[v]) * rstd[v];
      if (relu) t = fmaxf(t, 0.f);
      if (res != nullptr) t += to_f(rw.v[v]);
      f[v] = t;
    }
    W o;
    pack(o, f);
    yv[base + r * p.groups] = o;
  }
}

// This rank's fp32 sums of g' and g' * xhat per (b, c) into out[(b c + ch) 2
// ...] (sums, not means: the host adds the ranks' before dividing).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 1)
instance_norm_bwd_sums_kernel(const T* __restrict__ x, const T* __restrict__ g,
                              const float* __restrict__ ms, float* __restrict__ partial,
                              float* __restrict__ out, Plan p, int relu) {
  using W = Vec<T, V>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* red_g = reinterpret_cast<float*>(smem);
  float* red_gx = red_g + kThreads * V;

  const int tid = threadIdx.x;
  const int lane_p = tid / p.tile, gl = tid % p.tile;
  const int items = p.batch * p.tiles * p.chunks;
  const W* xv = reinterpret_cast<const W*>(x);
  const W* gv = reinterpret_cast<const W*>(g);

  for (int q = blockIdx.x; q < items; q += gridDim.x) {
    const Item w = item(p, q);
    const int gi = w.g0 + gl;
    const bool active = lane_p < p.pix && gi < p.groups;
    const long long base = static_cast<long long>(w.b) * p.hw * p.groups + gi;
    float sg[V], sgx[V], mean[V], rstd[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sg[v] = sgx[v] = mean[v] = rstd[v] = 0.f;
      if (active) {
        const float* st = ms + 2 * (static_cast<long long>(w.b) * p.c + gi * V + v);
        mean[v] = st[0];
        rstd[v] = st[1];
      }
    }
    for (int k0 = 0; k0 < w.iters; k0 += kBatch) {
      W xb[kBatch], gb[kBatch];
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk) {
        const long long r = w.r0 + lane_p + static_cast<long long>(k0 + kk) * p.pix;
        if (active && k0 + kk < w.iters && r < w.r1) {
          xb[kk] = xv[base + r * p.groups];
          gb[kk] = gv[base + r * p.groups];
        }
      }
#pragma unroll
      for (int kk = 0; kk < kBatch; ++kk) {
        const long long r = w.r0 + lane_p + static_cast<long long>(k0 + kk) * p.pix;
        if (active && k0 + kk < w.iters && r < w.r1) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float xh = (to_f(xb[kk].v[v]) - mean[v]) * rstd[v];
            float gg = to_f(gb[kk].v[v]);
            if (relu && !(xh > 0.f)) gg = 0.f;
            sg[v] += gg;
            sgx[v] += gg * xh;
          }
        }
      }
    }
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
    __syncthreads();
  }

  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  grid.sync();

  const int lane = tid % 32;
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long i = (static_cast<long long>(blockIdx.x) * kThreads + tid) / 32;
       i < static_cast<long long>(p.batch) * p.c; i += warps) {
    const long long b = i / p.c, ch = i % p.c;
    float a = 0.f, ax = 0.f;
    for (int k = lane; k < p.chunks; k += 32) {
      const float* q = partial + ((b * p.chunks + k) * p.c + ch) * 2;
      a += q[0];
      ax += q[1];
    }
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      ax += __shfl_down_sync(0xffffffffu, ax, off);
    }
    if (lane == 0) {
      out[2 * i] = a;
      out[2 * i + 1] = ax;
    }
  }
}

// parts: the S ranks' sums (S, batch, c, 2), added in rank order and divided
// by the global count; dx = rstd (g' - mean(g') - xhat mean(g' xhat)).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g,
                            const float* __restrict__ ms, const float* __restrict__ parts,
                            T* __restrict__ dx, ApplyPlan p, int relu, float count) {
  using W = Vec<T, V>;
  const int tid = threadIdx.x;
  const int lane_p = tid / p.tile, gl = tid % p.tile;
  const long long q = blockIdx.x;
  const int chunk = static_cast<int>(q % p.chunks);
  const long long slab = q / p.chunks;
  const int b = static_cast<int>(slab / p.tiles), tile = static_cast<int>(slab % p.tiles);
  const int gi = tile * p.tile + gl;
  if (lane_p >= p.pix || gi >= p.groups) return;
  const float inv = 1.0f / count;
  float mean[V], rstd[V], gm[V], gx[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const long long i = static_cast<long long>(b) * p.c + gi * V + v;
    mean[v] = ms[2 * i];
    rstd[v] = ms[2 * i + 1];
    float a = 0.f, ax = 0.f;
    for (int s = 0; s < p.parts; ++s) {
      const float* o = parts + (static_cast<long long>(s) * p.batch * p.c + i) * 2;
      a += o[0];
      ax += o[1];
    }
    gm[v] = a * inv;
    gx[v] = ax * inv;
  }
  const W* xv = reinterpret_cast<const W*>(x);
  const W* gv = reinterpret_cast<const W*>(g);
  W* dv = reinterpret_cast<W*>(dx);
  const long long base = static_cast<long long>(b) * p.hw * p.groups + gi;
  const long long r0 = chunk * p.rows_per_chunk;
  const long long r1 = min(r0 + p.rows_per_chunk, p.hw);
#pragma unroll 4
  for (int k = 0; k < kApplyIters; ++k) {
    const long long r = r0 + lane_p + static_cast<long long>(k) * p.pix;
    if (r >= r1) break;
    const W xw = xv[base + r * p.groups], gw = gv[base + r * p.groups];
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
  }
}

// The most blocks of a cooperative kernel resident at once on the current
// device at ``smem`` bytes of dynamic shared memory a block, asked once per
// device and kernel.
template <const void* (*Kernel)()>
int coop_blocks(int smem, int* blocks) {
  static int known[kMaxDevices] = {};
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < kMaxDevices && known[dev] > 0) {
    *blocks = known[dev];
    return 0;
  }
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) rc = cudaFuncSetAttribute(Kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel(), kThreads, smem);
  }
  *blocks = per_sm * sms;
  if (rc == cudaSuccess && dev < kMaxDevices) known[dev] = *blocks;
  return static_cast<int>(rc);
}

template <typename T, int V>
const void* stats_kernel() { return reinterpret_cast<const void*>(instance_norm_stats_kernel<T, V>); }
template <typename T, int V>
const void* sums_kernel() { return reinterpret_cast<const void*>(instance_norm_bwd_sums_kernel<T, V>); }

template <typename T, int V>
int run_stats(const void* x, float* partial, float* out, long long hw, int batch, int c,
              int chunk_cap, cudaStream_t s) {
  const int smem = kThreads * (1 + 2 * V) * static_cast<int>(sizeof(float));
  int blocks = 0;
  const int rc = coop_blocks<stats_kernel<T, V>>(smem, &blocks);
  if (rc != 0) return rc;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = 0;
  Plan p = make_plan(hw, batch, c, V, blocks, chunk_cap, &grid);
  const T* xt = static_cast<const T*>(x);
  void* args[] = {&xt, &partial, &out, &p};
  return static_cast<int>(cudaLaunchCooperativeKernel(stats_kernel<T, V>(), dim3(grid),
                                                      dim3(kThreads), args,
                                                      static_cast<size_t>(smem), s));
}

template <typename T, int V>
int run_sums(const void* x, const void* g, const float* ms, float* partial, float* out,
             long long hw, int batch, int c, int chunk_cap, int relu, cudaStream_t s) {
  const int smem = kThreads * 2 * V * static_cast<int>(sizeof(float));
  int blocks = 0;
  const int rc = coop_blocks<sums_kernel<T, V>>(smem, &blocks);
  if (rc != 0) return rc;
  if (blocks < 1) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  int grid = 0;
  Plan p = make_plan(hw, batch, c, V, blocks, chunk_cap, &grid);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  void* args[] = {&xt, &gt, &ms, &partial, &out, &p, &relu};
  return static_cast<int>(cudaLaunchCooperativeKernel(sums_kernel<T, V>(), dim3(grid),
                                                      dim3(kThreads), args,
                                                      static_cast<size_t>(smem), s));
}

template <typename T, int V>
int run_apply(const void* x, const void* res, void* y, const float* parts, float* ms,
              long long hw, int batch, int c, int n_parts, int relu, float eps, cudaStream_t s) {
  long long grid = 0;
  const ApplyPlan p = make_apply_plan(hw, batch, c, V, n_parts, &grid);
  if (grid < 1 || grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  instance_norm_apply_kernel<T, V><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res), static_cast<T*>(y), parts, ms, p,
      relu, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int run_dx(const void* x, const void* g, const float* ms, const float* parts, void* dx,
           long long hw, int batch, int c, int n_parts, int relu, float count, cudaStream_t s) {
  long long grid = 0;
  const ApplyPlan p = make_apply_plan(hw, batch, c, V, n_parts, &grid);
  if (grid < 1 || grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  instance_norm_bwd_dx_kernel<T, V><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), ms, parts, static_cast<T*>(dx), p, relu,
      count);
  return static_cast<int>(cudaGetLastError());
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

// out: (batch, c, 3) this rank's count, mean and M2; partial: batch *
// chunk_cap * c * 3.
extern "C" int instance_norm_stats_launch(const void* x, void* partial, void* out, long long hw,
                                          int batch, int c, int chunk_cap, int vec, int elt_size,
                                          void* stream) {
  if (bad_operands(hw, batch, c, vec, elt_size) || chunk_cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pt = static_cast<float*>(partial);
  float* ot = static_cast<float*>(out);
  return K3_DISPATCH(run_stats, x, pt, ot, hw, batch, c, chunk_cap, s);
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
// rank's sums of g' and g' * xhat; partial: batch * chunk_cap * c * 2.
extern "C" int instance_norm_bwd_sums_launch(const void* x, const void* g, const void* ms,
                                             void* partial, void* out, long long hw, int batch,
                                             int c, int chunk_cap, int relu, int vec, int elt_size,
                                             void* stream) {
  if (bad_operands(hw, batch, c, vec, elt_size) || chunk_cap < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* mt = static_cast<const float*>(ms);
  float* pt = static_cast<float*>(partial);
  float* ot = static_cast<float*>(out);
  return K3_DISPATCH(run_sums, x, g, mt, pt, ot, hw, batch, c, chunk_cap, relu, s);
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
