// The s2d head conv (kernel K4), for Hopper (sm_90a).
//
// Replaces jpdse_tpu/ops/pallas/head_conv.py::head_conv_s2d_pallas
// (_make_kernel): a VALID kp x kp conv of an s2d-padded input xp (B, Hp, Wp,
// C) against w-folded weights w (kp, kp*C, N), out (B, ho, wo, N) with
// wo = Wp - kp + 1, accumulated in fp32. Only rows [0, ho + kp - 1) of xp are
// read, so any ho <= Hp - kp + 1 is taken.
//
// It is a GEMM: M = B*ho*wo pixels, N output channels, K = kp*kp*C. The
// w-fold makes it one without an im2col copy: for kernel row dy, pixel
// (b, i, j) contracts the kp*C values xp[b, i+dy, j : j+kp, :], which are
// contiguous, against w[dy]. So A's row for (pixel, dy) is a slice of xp
// starting at ((b*Hp + i + dy)*Wp + j)*C, and the rows of neighbouring
// pixels overlap by (kp-1)*C.
//
// Bound: operations. The netG head at the flagship (1, 260, 515, 156) ->
// (1, 256, 512, 256) is 2*131072*256*2496 = 0.168 TFLOP: 0.169 ms at the
// 989 TFLOP/s bf16 dense peak, against 0.033 ms for its 110 MB of device
// memory.
//
// Design, bf16: a block of 8 warps computes a 128 x 128 output tile with
// WMMA (bf16 in, fp32 accumulate, 16x16x16), each warp 32 x 64. K runs
// over the kp kernel rows and, within each, over the kp*C folded channels
// in steps of 48 (three WMMA steps); A and B tiles go to shared memory in
// 8-byte words (C is a multiple of 4, so every row start is 8-byte
// aligned). One buffer, no TMA, no wgmma: right and simple first.
// fp32: the same tiling on CUDA cores, 64 x 64 per block, 4 x 4 outputs a
// thread, no TF32, so that the fp32 path holds the plain conv's digits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

struct Geometry {
  int hp, wp, c, n, kp, ho, wo;
  long long m;  // B * ho * wo
  int kd;       // kp * C, the folded channels of one kernel row
};

// Offset of xp[b, i, j, 0] for output pixel m (before the dy row shift).
__device__ __forceinline__ long long pixel_base(const Geometry& g, long long m) {
  const long long per_image = static_cast<long long>(g.ho) * g.wo;
  const long long b = m / per_image;
  const long long rem = m - b * per_image;
  const int i = static_cast<int>(rem / g.wo);
  const int j = static_cast<int>(rem - static_cast<long long>(i) * g.wo);
  return ((b * g.hp + i) * g.wp + j) * g.c;
}

namespace bf16_path {

constexpr int kBM = 128, kBN = 128, kBK = 48, kThreads = 256;
constexpr int kPadA = kBK + 8, kPadB = kBN + 8;  // row strides, multiples of 8 (WMMA ldm)

__global__ void __launch_bounds__(kThreads)
head_conv_kernel(const bf16* __restrict__ xp, const bf16* __restrict__ w, bf16* __restrict__ out,
                 Geometry g) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 a_s[kBM][kPadA];
  __shared__ __align__(32) bf16 b_s[kBK][kPadB];
  __shared__ __align__(32) float c_s[kThreads / 32][16 * 16];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;  // warp tile: rows wm*32, columns wn*64
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A: 128 rows x 12 words of 4 bf16 = 1536 words, 6 per thread
  constexpr int kAWords = kBM * kBK / 4 / kThreads;
  long long a_base[kAWords];
  int a_row[kAWords], a_k[kAWords];
#pragma unroll
  for (int q = 0; q < kAWords; ++q) {
    const int word = tid + q * kThreads;
    a_row[q] = word / (kBK / 4);
    a_k[q] = (word % (kBK / 4)) * 4;
    const long long m = m0 + a_row[q];
    a_base[q] = m < g.m ? pixel_base(g, m) : -1;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const uint2 zero = make_uint2(0u, 0u);
  for (int dy = 0; dy < g.kp; ++dy) {
    const long long row_shift = static_cast<long long>(dy) * g.wp * g.c;
    const bf16* w_dy = w + static_cast<long long>(dy) * g.kd * g.n;
    for (int k0 = 0; k0 < g.kd; k0 += kBK) {
#pragma unroll
      for (int q = 0; q < kAWords; ++q) {
        const int k = k0 + a_k[q];
        uint2 v = zero;
        if (a_base[q] >= 0 && k < g.kd) {
          v = *reinterpret_cast<const uint2*>(xp + a_base[q] + row_shift + k);
        }
        *reinterpret_cast<uint2*>(&a_s[a_row[q]][a_k[q]]) = v;
      }
      // B: 48 rows x 32 words of 4 bf16 = 1536 words, 6 per thread
#pragma unroll
      for (int q = 0; q < kBK * kBN / 4 / kThreads; ++q) {
        const int word = tid + q * kThreads;
        const int kk = word / (kBN / 4), nn = (word % (kBN / 4)) * 4;
        const int k = k0 + kk, n = n0 + nn;
        uint2 v = zero;
        if (k < g.kd && n < g.n) {
          v = *reinterpret_cast<const uint2*>(w_dy + static_cast<long long>(k) * g.n + n);
        }
        *reinterpret_cast<uint2*>(&b_s[kk][nn]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(fa[i], &a_s[wm * 32 + i * 16][kk], kPadA);
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::load_matrix_sync(fb[j], &b_s[kk][wn * 64 + j * 16], kPadB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // epilogue: each 16x16 fragment through the warp's staging tile, one cast
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(c_s[warp], acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const long long m = m0 + wm * 32 + i * 16 + e / 16;
        const int n = n0 + wn * 64 + j * 16 + e % 16;
        if (m < g.m && n < g.n) out[m * g.n + n] = __float2bfloat16(c_s[warp][e]);
      }
      __syncwarp();
    }
  }
}

}  // namespace bf16_path

namespace fp32_path {

constexpr int kBM = 64, kBN = 64, kBK = 16, kThreads = 256;

__global__ void __launch_bounds__(kThreads)
head_conv_kernel(const float* __restrict__ xp, const float* __restrict__ w,
                 float* __restrict__ out, Geometry g) {
  __shared__ __align__(16) float a_s[kBK][kBM];  // transposed: k-major
  __shared__ __align__(16) float b_s[kBK][kBN];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // A: 64 rows x 4 float4 = 256 words, one per thread
  const int a_row = tid / 4, a_k = (tid % 4) * 4;
  const long long m_load = m0 + a_row;
  const long long a_base = m_load < g.m ? pixel_base(g, m_load) : -1;
  // B: 16 rows x 16 float4 = 256 words, one per thread
  const int b_k = tid / 16, b_n = (tid % 16) * 4;

  float acc[4][4] = {};
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int dy = 0; dy < g.kp; ++dy) {
    const long long row_shift = static_cast<long long>(dy) * g.wp * g.c;
    const float* w_dy = w + static_cast<long long>(dy) * g.kd * g.n;
    for (int k0 = 0; k0 < g.kd; k0 += kBK) {
      float4 a = zero, b = zero;
      if (a_base >= 0 && k0 + a_k < g.kd) {
        a = *reinterpret_cast<const float4*>(xp + a_base + row_shift + k0 + a_k);
      }
      a_s[a_k + 0][a_row] = a.x;
      a_s[a_k + 1][a_row] = a.y;
      a_s[a_k + 2][a_row] = a.z;
      a_s[a_k + 3][a_row] = a.w;
      if (k0 + b_k < g.kd && n0 + b_n < g.n) {
        b = *reinterpret_cast<const float4*>(w_dy + static_cast<long long>(k0 + b_k) * g.n + n0 + b_n);
      }
      *reinterpret_cast<float4*>(&b_s[b_k][b_n]) = b;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&a_s[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&b_s[kk][tx * 4]);
        const float ar[4] = {av.x, av.y, av.z, av.w};
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty * 4 + i;
    if (m >= g.m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.n) out[m * g.n + n] = acc[i][j];
    }
  }
}

}  // namespace fp32_path

}  // namespace

// xp: (batch, hp, wp, c) contiguous; w: (kp, kp*c, n) contiguous; out:
// (batch, ho, wp - kp + 1, n) contiguous, allocated by the caller; all three
// 16-byte aligned, c and n multiples of 4, ho + kp - 1 <= hp. elt_size 2 is
// bf16, 4 is fp32. Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int head_conv_s2d_launch(const void* xp, const void* w, void* out, long long batch,
                                    int hp, int wp, int c, int n, int kp, int ho, int elt_size,
                                    void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out);
  if (batch < 1 || kp < 1 || ho < 1 || ho + kp - 1 > hp || wp < kp || c < 4 || c % 4 ||
      n < 4 || n % 4 || align % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g{hp, wp, c, n, kp, ho, wp - kp + 1, 0, kp * c};
  g.m = batch * ho * g.wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elt_size == 2) {
    using namespace bf16_path;
    const dim3 grid(static_cast<unsigned>((g.m + kBM - 1) / kBM), (n + kBN - 1) / kBN);
    head_conv_kernel<<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(xp),
                                               static_cast<const bf16*>(w),
                                               static_cast<bf16*>(out), g);
  } else if (elt_size == 4) {
    using namespace fp32_path;
    const dim3 grid(static_cast<unsigned>((g.m + kBM - 1) / kBM), (n + kBN - 1) / kBN);
    head_conv_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(xp),
                                               static_cast<const float*>(w),
                                               static_cast<float*>(out), g);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
