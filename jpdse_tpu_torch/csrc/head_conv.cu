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
// contiguous, against w[dy]; folded row dx*C + c of w[dy] is row
// (dy*kp + dx)*C + c of w viewed as (kp*kp*C, N).
//
// Bound: operations. The netG head at the flagship, 156 channels, is
// 2*131072*256*2496 = 0.168 TFLOP: 0.169 ms at the 989 TFLOP/s bf16 dense
// peak, against 0.033 ms for its 110 MB of device memory. The kernel is
// handed (1, 260, 515, 160): the 4 zero channels its producer pads to are
// 2.6% more work, counted as part of its gap to the bound.
//
// Two routes, by dtype:
// - bf16 (C and N multiples of 8, N <= 256; ops/head_conv.py pads other
//   shapes with zeros): wgmma. A persistent grid, one block per SM, walks
//   output tiles of 128 pixels of one output row x 256 channels. One
//   producer thread keeps a ring of 6 stages in flight with TMA: A's stage
//   for tap (dy, dx) and channels c0..c0+31 is one box of xp viewed as
//   (B*Hp*Wp, C), rows (b*Hp + i + dy)*Wp + j0 + dx .. +127 (the implicit
//   GEMM: no im2col copy; the 16 taps' boxes overlap and are served from
//   L2), and B's is 32 rows of w as four 64-channel boxes. Two consumer
//   warp groups issue wgmma m64n256k16 (bf16 in, fp32 accumulate) on the
//   stages that have arrived and release each stage once the next one's
//   products are issued; the epilogue casts once. TMA needs 16-byte row
//   strides, so C must be a multiple of 8: the netG head's 156 channels
//   are padded to 160 by its producer (K1's `channels`), with zero weights.
//   Its dense-A mode multiplies a materialised (M, K) matrix instead of the
//   windowed xp: the same main loop with A's box at (t*128, k0), which
//   isolates the windowing from the GEMM (head_conv_gemm_launch).
// - fp32: CUDA cores, 64 x 64 outputs per block, 4 x 4 a thread, no TF32,
//   so that the fp32 path holds the plain conv's digits.

#include <cuda.h>  // CUtensorMap and its enums; the function comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

namespace wgmma_path {

// One block per SM walks output tiles of kBM pixels x kBN channels. Warp
// groups 0 and 1 consume (64 rows each), warp group 2's first thread
// produces: a ring of kStages (A, B) stages filled by TMA.
constexpr int kBM = 128, kBN = 256, kBK = 32, kStages = 6, kConsumers = 2;
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kABytes = kBM * kBK * 2;        // 128 rows x 64 B, 64-byte swizzle
constexpr int kBBoxBytes = kBK * 64 * 2;      // 32 K rows x 64 channels, 128-byte swizzle
constexpr int kBBytes = kBBoxBytes * (kBN / 64);
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kSmemBytes = kStages * kStageBytes + 1024;  // + slack to align the ring to 1 KB

struct Shape {
  int tiles, k_steps;
  // conv: A is xp viewed as (B*Hp*Wp, C); K step s is tap s / steps_per_tap,
  // channels (s % steps_per_tap) * kBK
  int steps_per_tap, c, kp, hp, wp, ho, wo, tiles_per_row;
  long long m;  // dense: A is (m, K)
  int n;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row)
      : "memory");
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), layout 1 = 128-byte swizzle, 2 = 64-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// D (64 x 256, fp32, registers) += A (64 x 16, K-major) * B (16 x 256,
// N-major), both from shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

template <bool kDense>
__global__ void __launch_bounds__(kThreads, 1)
gemm_kernel(const __grid_constant__ CUtensorMap tma_a, const __grid_constant__ CUtensorMap tma_b,
            bf16* __restrict__ out, Shape g) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kStages], empty_bar[kStages];
  const uint32_t ring = (smem_u32(smem_raw) + 1023) & ~1023u;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);                     // the producer's expect_tx
      mbar_init(smem_u32(&empty_bar[s]), kConsumers * 4);       // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t round = 0;
      for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
        int a_row = 0, b_base = 0;
        if (kDense) {
          a_row = t * kBM;
        } else {
          const int jt = t % g.tiles_per_row, bi = t / g.tiles_per_row;
          const int i = bi % g.ho, b = bi / g.ho;
          a_row = (b * g.hp + i) * g.wp + jt * kBM;
        }
        for (int s = 0; s < g.k_steps; ++s) {
          int a_col, a_r = a_row;
          if (kDense) {
            a_col = s * kBK;
            b_base = a_col;
          } else {
            const int tap = s / g.steps_per_tap;
            a_col = (s - tap * g.steps_per_tap) * kBK;
            a_r = a_row + (tap / g.kp) * g.wp + tap % g.kp;
            b_base = tap * g.c + a_col;
          }
          mbar_wait(smem_u32(&empty_bar[stage]), round ^ 1);
          const uint32_t full = smem_u32(&full_bar[stage]);
          const uint32_t a_dst = ring + stage * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
          tma_load_2d(a_dst, &tma_a, full, a_col, a_r);
#pragma unroll
          for (int q = 0; q < kBN / 64; ++q) {
            tma_load_2d(a_dst + kABytes + q * kBBoxBytes, &tma_b, full, q * 64, b_base);
          }
          if (++stage == kStages) {
            stage = 0;
            round ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warp group wg computes rows [wg*64, wg*64 + 64) of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    float acc[128];
#pragma unroll
    for (int j = 0; j < 128; ++j) acc[j] = 0.f;
    int stage = 0;
    uint32_t round = 0;
    for (int t = blockIdx.x; t < g.tiles; t += gridDim.x) {
      int prev = -1;
      for (int s = 0; s < g.k_steps; ++s) {
        mbar_wait(smem_u32(&full_bar[stage]), round);
        const uint32_t a_src = ring + stage * kStageBytes;
        const uint64_t da = make_desc(a_src + wg * 64 * (kBK * 2), 16, 8 * kBK * 2, 2);
        const uint64_t db = make_desc(a_src + kABytes, kBBoxBytes, 8 * 128, 1);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
        // k 0..15 then 16..31: A's row advances 32 bytes, B's 16 rows of 128 bytes
        wgmma_m64n256k16(acc, da, db, s > 0);
        wgmma_m64n256k16(acc, da + (32 >> 4), db + ((16 * 128) >> 4), 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        if (prev >= 0) {
          asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
          if (lane == 0) mbar_arrive(smem_u32(&empty_bar[prev]));
        }
        prev = stage;
        if (++stage == kStages) {
          stage = 0;
          round ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0 && prev >= 0) mbar_arrive(smem_u32(&empty_bar[prev]));

      // epilogue: accumulator j holds row warp*16 + lane/4 + 8*((j/2)%2),
      // column (j/4)*8 + (lane%4)*2 + j%2 of this warp group's 64 rows
      const int r0 = wg * 64 + warp * 16 + lane / 4;
      long long base[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        base[h] = -1;
        if (kDense) {
          const long long m = static_cast<long long>(t) * kBM + r;
          if (m < g.m) base[h] = m * g.n;
        } else {
          const int jt = t % g.tiles_per_row, bi = t / g.tiles_per_row;
          const int j = jt * kBM + r;
          if (j < g.wo) base[h] = (static_cast<long long>(bi) * g.wo + j) * g.n;
        }
      }
#pragma unroll
      for (int j = 0; j < 128; j += 2) {
        const int h = (j / 2) % 2;
        const int col = (j / 4) * 8 + (lane % 4) * 2;
        if (base[h] >= 0 && col < g.n) {
          *reinterpret_cast<__nv_bfloat162*>(out + base[h] + col) =
              __floats2bfloat162_rn(acc[j], acc[j + 1]);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: take it from the
// runtime's entry-point table, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (rc == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map over (rows, cols) row-major, boxes of box_rows x
// box_cols; elements outside the tensor read as zero.
bool make_map(CUtensorMap* map, const void* base, long long rows, long long cols, int box_rows,
              int box_cols, CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (a_rows, a_cols) and B (b_rows, n) bf16 maps, then the persistent launch.
template <bool kDense>
int launch(const void* a, long long a_rows, int a_cols, const void* b, long long b_rows,
           bf16* out, Shape g, cudaStream_t s) {
  CUtensorMap map_a, map_b;
  if (!make_map(&map_a, a, a_rows, a_cols, kBM, kBK, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map(&map_b, b, b_rows, g.n, kBK, 64, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess) {
    rc = cudaFuncSetAttribute(gemm_kernel<kDense>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemBytes);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int grid = g.tiles < sms ? g.tiles : sms;
  gemm_kernel<kDense><<<grid, kThreads, kSmemBytes, s>>>(map_a, map_b, out, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wgmma_path

}  // namespace

// xp: (batch, hp, wp, c) contiguous; w: (kp, kp*c, n) contiguous; out:
// (batch, ho, wp - kp + 1, n) contiguous, allocated by the caller; all three
// 16-byte aligned, ho + kp - 1 <= hp. elt_size 2 is bf16 (wgmma: c and n
// multiples of 8, n <= 256), 4 is fp32 (CUDA cores: c and n multiples of 4).
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int head_conv_s2d_launch(const void* xp, const void* w, void* out, long long batch,
                                    int hp, int wp, int c, int n, int kp, int ho, int elt_size,
                                    void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(xp) | reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out);
  if (batch < 1 || kp < 1 || ho < 1 || ho + kp - 1 > hp || wp < kp || c < 4 || c % 4 ||
      n < 4 || n % 4 || align % 16 || (elt_size != 2 && elt_size != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geometry g{hp, wp, c, n, kp, ho, wp - kp + 1, 0, kp * c};
  g.m = batch * ho * g.wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elt_size == 2) {
    using namespace wgmma_path;
    if (c % 8 || n % 8 || n > kBN || batch * hp * wp >= (1LL << 31)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    Shape sh{};
    sh.tiles_per_row = (g.wo + kBM - 1) / kBM;
    const long long tiles = batch * ho * sh.tiles_per_row;
    sh.tiles = static_cast<int>(tiles);
    sh.steps_per_tap = (c + kBK - 1) / kBK;
    sh.k_steps = kp * kp * sh.steps_per_tap;
    sh.c = c;
    sh.kp = kp;
    sh.hp = hp;
    sh.wp = wp;
    sh.ho = ho;
    sh.wo = g.wo;
    sh.n = n;
    return wgmma_path::launch<false>(xp, batch * hp * wp, c, w, static_cast<long long>(kp) * kp * c,
                                     static_cast<bf16*>(out), sh, s);
  }
  using namespace fp32_path;
  const dim3 grid(static_cast<unsigned>((g.m + kBM - 1) / kBM), (n + kBN - 1) / kBN);
  head_conv_kernel<<<grid, kThreads, 0, s>>>(static_cast<const float*>(xp),
                                             static_cast<const float*>(w),
                                             static_cast<float*>(out), g);
  return static_cast<int>(cudaGetLastError());
}

// K4's dense-A mode: out (m, n) = a (m, k) @ b (k, n), bf16 in, fp32
// accumulate, one cast; all contiguous and 16-byte aligned, k and n
// multiples of 8, n <= 256. Returns a cudaError_t.
extern "C" int head_conv_gemm_launch(const void* a, const void* b, void* out, long long m, int k,
                                     int n, void* stream) {
  using namespace wgmma_path;
  const uintptr_t align = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(out);
  if (m < 1 || k < 8 || k % 8 || n < 8 || n % 8 || n > kBN || align % 16 ||
      (m + kBM - 1) / kBM >= (1LL << 31) || m >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape sh{};
  sh.tiles = static_cast<int>((m + kBM - 1) / kBM);
  sh.k_steps = (k + kBK - 1) / kBK;
  sh.m = m;
  sh.n = n;
  return wgmma_path::launch<true>(a, m, k, b, k, static_cast<bf16*>(out), sh,
                                  static_cast<cudaStream_t>(stream));
}
