// Fused InstanceNorm (+ReLU) (+residual) (kernel K3, forward), for Hopper
// (sm_90a).
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

// Dynamic shared memory of one block: all the device lets a block opt in
// to, so one block sits on each SM and caches what it can.
int smem_bytes(int* bytes) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return static_cast<int>(rc);
}

constexpr int kMaxDevices = 64;

// The most blocks of instance_norm_kernel<T, V> resident at once on the
// current device (its SM count x blocks per SM at smem_bytes), which is
// the most a cooperative launch takes. Asked once per device: the launch
// is on the host's critical path at batch 1.
template <typename T, int V>
int max_blocks(int* blocks) {
  static int known[kMaxDevices] = {};
  int dev = 0, sms = 0, smem = 0, per_sm = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < kMaxDevices && known[dev] > 0) {
    *blocks = known[dev];
    return 0;
  }
  rc = static_cast<cudaError_t>(smem_bytes(&smem));
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(instance_norm_kernel<T, V>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (rc == cudaSuccess) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, instance_norm_kernel<T, V>,
                                                       kThreads, smem);
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
  }
  p.rows_per_chunk = (hw + chunks - 1) / chunks;
  p.chunks = static_cast<int>((hw + p.rows_per_chunk - 1) / p.rows_per_chunk);
  const long long items = slabs * p.chunks;
  *grid = static_cast<int>(items < blocks ? items : blocks);
  return p;
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
  const int rc = elt_size == 2 ? (vec ? max_blocks<bf16, 8>(&blocks) : max_blocks<bf16, 1>(&blocks))
                               : (vec ? max_blocks<float, 4>(&blocks) : max_blocks<float, 1>(&blocks));
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
