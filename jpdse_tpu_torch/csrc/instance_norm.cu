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
// The TPU kernel held a whole slab in VMEM. Here a slab of 524,288 pixels
// per channel (67 MB for 64 channels, more than the 50 MB L2) cannot sit in
// one block, so the statistics are a split reduction across blocks, made
// deterministic and numerically sound:
//   1. stats: a block takes a chunk of rows and 32 channels (channels are
//      the contiguous axis: a warp reads 32 neighbouring channels of one
//      pixel); each thread keeps a Welford (count, mean, M2) over its rows,
//      the block merges its 8 row-threads per channel in a fixed order
//      (Chan et al.) and writes one partial per (b, chunk, c);
//   2. finalize: one warp per (b, c) merges the chunks' partials in a
//      fixed order into mean and rstd;
//   3. normalize: one thread per element of a batch element, reading x
//      (and the residual) again.
// No float atomics, so two runs give the same bits, and no raw sum of
// squares, which cancels on inputs far from zero mean. x is read twice,
// so the kernel can reach at best two thirds of the byte bound; keeping
// the second read in L2 or fusing the statistics into the producing conv
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kChannels = 32;  // threads along C in a stats block
constexpr int kRows = 8;       // threads along H*W in a stats block

__device__ __forceinline__ float load(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load(const bf16* p, long long i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(bf16* p, long long i, float v) { p[i] = __float2bfloat16(v); }

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

// grid (chunks, ceil(C/32), B), block (32, 8). partial: (B, chunks, C, 3).
template <typename T>
__global__ void __launch_bounds__(kChannels * kRows)
stats_kernel(const T* __restrict__ x, float* __restrict__ partial, long long hw, int c,
             long long rows_per_chunk) {
  __shared__ Moments part[kRows][kChannels];
  const int chunk = blockIdx.x, b = blockIdx.z;
  const int ch = blockIdx.y * kChannels + threadIdx.x;
  const long long r0 = chunk * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk, hw);
  Moments s{0.f, 0.f, 0.f};
  if (ch < c) {
    const T* xb = x + static_cast<long long>(b) * hw * c + ch;
    for (long long r = r0 + threadIdx.y; r < r1; r += kRows) {
      const float v = load(xb, r * c);
      s.n += 1.f;
      const float delta = v - s.mean;
      s.mean += delta / s.n;
      s.m2 += delta * (v - s.mean);
    }
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && ch < c) {
    Moments t = part[0][threadIdx.x];
    for (int i = 1; i < kRows; ++i) t = merge(t, part[i][threadIdx.x]);
    float* p = partial + ((static_cast<long long>(b) * gridDim.x + chunk) * c + ch) * 3;
    p[0] = t.n;
    p[1] = t.mean;
    p[2] = t.m2;
  }
}

// One warp per (b, c): stats (B, C, 2) = (mean, rstd). Lane l merges chunks
// l, l + 32, ... in order, then the lanes merge in a fixed tree, so the
// result does not depend on scheduling. (One thread walking 500 chunks
// measured 38 us a call on average: a chain of dependent loads.)
__global__ void finalize_kernel(const float* __restrict__ partial, float* __restrict__ stats,
                                int batch, int c, int chunks, float eps) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (i >= batch * c) return;  // i is the same for the whole warp
  const int b = i / c, ch = i % c;
  Moments t{0.f, 0.f, 0.f};
  for (int k = lane; k < chunks; k += 32) {
    const float* p = partial + ((static_cast<long long>(b) * chunks + k) * c + ch) * 3;
    t = merge(t, Moments{p[0], p[1], p[2]});
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

// grid (blocks, B); the index within one batch element fits 32 bits.
template <typename T, bool kRelu, bool kResidual>
__global__ void normalize_kernel(const T* __restrict__ x, const T* __restrict__ res,
                                 const float* __restrict__ stats, T* __restrict__ y,
                                 unsigned hwc, unsigned c) {
  const long long off = static_cast<long long>(blockIdx.y) * hwc;
  const float* st = stats + 2LL * blockIdx.y * c;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < hwc; i += gridDim.x * blockDim.x) {
    const unsigned ch = i % c;
    float v = (load(x, off + i) - st[2 * ch]) * st[2 * ch + 1];
    if (kRelu) v = fmaxf(v, 0.f);
    if (kResidual) v += load(res, off + i);
    store(y, off + i, v);
  }
}

template <typename T>
int run(const void* x_, const void* res_, void* y_, float* partial, float* stats, int batch,
        long long hw, int c, int chunks, long long rows_per_chunk, int relu, float eps,
        cudaStream_t s) {
  const T* x = static_cast<const T*>(x_);
  const T* res = static_cast<const T*>(res_);
  T* y = static_cast<T*>(y_);
  const dim3 grid(chunks, (c + kChannels - 1) / kChannels, batch);
  stats_kernel<T><<<grid, dim3(kChannels, kRows), 0, s>>>(x, partial, hw, c, rows_per_chunk);
  const long long bc = static_cast<long long>(batch) * c;
  finalize_kernel<<<static_cast<unsigned>((bc * 32 + 255) / 256), 256, 0, s>>>(
      partial, stats, batch, c, chunks, eps);
  const unsigned hwc = static_cast<unsigned>(hw * c), uc = static_cast<unsigned>(c);
  long long blocks = (hwc + 255) / 256;
  const long long cap = 132LL * 32 / batch + 1;  // ~32 blocks per SM; the loop strides beyond
  const dim3 ngrid(static_cast<unsigned>(blocks < cap ? blocks : cap), batch);
  if (res != nullptr) {
    if (relu) normalize_kernel<T, true, true><<<ngrid, 256, 0, s>>>(x, res, stats, y, hwc, uc);
    else normalize_kernel<T, false, true><<<ngrid, 256, 0, s>>>(x, res, stats, y, hwc, uc);
  } else {
    if (relu) normalize_kernel<T, true, false><<<ngrid, 256, 0, s>>>(x, res, stats, y, hwc, uc);
    else normalize_kernel<T, false, false><<<ngrid, 256, 0, s>>>(x, res, stats, y, hwc, uc);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, res (nullable), y: (batch, hw, c) contiguous, of one type (elt_size 2:
// bf16, 4: fp32). partial: fp32 workspace of batch * chunks * c * 3; stats:
// fp32 workspace of batch * c * 2; all allocated by the caller. The rows
// [k * rows_per_chunk, (k+1) * rows_per_chunk) form chunk k, and chunks *
// rows_per_chunk >= hw. Returns a cudaError_t: 0 when every launch was
// accepted.
extern "C" int instance_norm_launch(const void* x, const void* res, void* y, void* partial,
                                    void* stats, long long hw, long long rows_per_chunk,
                                    int batch, int c, int chunks, int relu, int elt_size,
                                    float eps, void* stream) {
  if (batch < 1 || hw < 1 || c < 1 || chunks < 1 || chunks > 65535 || batch > 65535 ||
      rows_per_chunk < 1 || static_cast<long long>(chunks) * rows_per_chunk < hw ||
      hw * c >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partial);
  float* st = static_cast<float*>(stats);
  if (elt_size == 2) return run<bf16>(x, res, y, p, st, batch, hw, c, chunks, rows_per_chunk, relu, eps, s);
  if (elt_size == 4) return run<float>(x, res, y, p, st, batch, hw, c, chunks, rows_per_chunk, relu, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
