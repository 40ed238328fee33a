// Grid re-alignment of a space-to-depth tensor (K1), and the one-pass entry
// of a fine tensor into the padded s2d domain (K2), for Hopper (sm_90a).
//
// K1 replaces jpdse_tpu/ops/pallas/realign.py::s2d_realign_pad3_pallas:
// out = space_to_depth(reflect_pad(depth_to_space(y), 3)), with `extra_rows`
// further rows of deeper reflection, mapping (B, hs, ws, 4C) to
// (B, hs + 3 + extra_rows, ws + 3, 4C). With `channels` > 4C it writes each
// output pixel's channels [4C, channels) as zeros: the head conv K4 reads
// its input through TMA, whose row strides must be multiples of 16 bytes,
// so K1 as K4's producer pads the netG head's 156 bf16 channels to 160.
// K2 replaces jpdse_tpu/ops/pallas/realign.py::s2d_pad3_pallas
// (_front_kernel): out = space_to_depth(reflect_pad(x, 3)) of a fine
// (B, H, W, C) tensor, with `extra_rows` likewise, mapping it to
// (B, H/2 + 3 + extra_rows, W/2 + 3, 4C).
// Elements are only moved, so both are bit-exact and the same for 2- and
// 4-byte types.
//
// Index map: output element (b, j, k, (pu*2 + pv)*C + c) is fine pixel
// (fm, fn) = (r(2j + pu - 3), r(2k + pv - 3)), where r reflects once into
// [0, 2hs) or [0, 2ws) (K1) or [0, H) or [0, W) (K2). K1 reads it from
// y[b, fm/2, fn/2, ((fm%2)*2 + fn%2)*C + c], K2 from x[b, fm, fn, c]. The
// Python mirrors of this arithmetic are jpdse_tpu_torch/ops/realign.py::
// _source_index and _front_source_index.
//
// Bound: device-memory bytes. K1 at the flagship's (1, 256, 512, 256) bf16
// reads 67.1 MB and writes 68.3 MB: 135.4 MB / 3.35 TB/s, about 40 us per
// launch (about 81 us in fp32). K2 at the netE front's (1, 512, 1024, 3)
// bf16 reads 3.1 MB and writes 3.2 MB: about 1.9 us; at C=36 and 39 (the
// other fronts, when K4 is off) about 23 and 25 us.
//
// K1's design: one thread per word of output in a grid-stride loop over at
// most 32 blocks per SM, the word being the widest of 16, 8 or 4 bytes that
// divides a tap's C channels when both pointers are aligned to it, else one
// element. Neighbouring threads write neighbouring words of an output row,
// and each tap's C channels are contiguous in the source too, so loads and
// stores are coalesced within a tap.
//
// K2's design (s2d_pad3_front_kernel): its channel counts (3, 36, 39) fill no
// 16-byte word of a tap, so K1's word-per-thread copy would move 2-, 8- and
// 2-byte words in bf16. But output row j reads only two fine rows, a = r(2j-3)
// for the pu=0 taps and b = r(2j-2) for pu=1, and away from the column edges
// output pixel k is a[2k-3 : 2k-1] ++ b[2k-3 : 2k-1]: the row is an interleave
// of 2C-element chunks of two contiguous source rows. So one block takes one
// tile of at most 16 KB of one output row (a whole row at C=3 in bf16): it
// stages the span of both source rows that the tile reads into shared memory
// with 16-byte asynchronous copies (cp.async; the unaligned first and last
// words element by element), then each thread gathers whole 16-byte output
// words from shared memory in registers and stores them (the unaligned head and
// tail of the tile element by element). Where 2C elements fill whole 16-byte
// words (C=36 in bf16), a word that lies inside one chunk of a pixel away from
// the edges is read from shared memory 8 or 4 bytes at a time where its
// alignment allows; any other word element by element, which is where the four
// edge pixels of a row (k = 0, 1, W/2+1, W/2+2) go: their column reflects
// inside the staged span. Index math is 32-bit inside a tile; the one division
// of each 16-byte word, by 2C, is a multiply and a shift by constants made on
// the host.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

__device__ __forceinline__ int reflect(int m, int n) {
  m = m < 0 ? -m : m;
  return m > n - 1 ? 2 * (n - 1) - m : m;
}

// K1. Word is the unit moved: uint4, uint2, uint32_t or one element.
// cw: words per tap (C * element size / sizeof(Word)); pw: words per output
// pixel (>= 4*cw; words past 4*cw are zero padding); hp: output rows.
template <typename Word>
__global__ void s2d_realign_pad3_kernel(const Word* __restrict__ y, Word* __restrict__ out,
                                        long long total, int hs, int ws, int cw, int pw, int hp) {
  const int wp = ws + 3;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += step) {
    long long t = i;
    const int q = static_cast<int>(t % pw);
    t /= pw;
    if (q >= 4 * cw) {
      out[i] = Word{};
      continue;
    }
    const int c = q % cw, tap = q / cw;
    const int k = static_cast<int>(t % wp);
    t /= wp;
    const int j = static_cast<int>(t % hp);
    const long long b = t / hp;
    const int fm = reflect(2 * j + (tap >> 1) - 3, 2 * hs);
    const int fn = reflect(2 * k + (tap & 1) - 3, 2 * ws);
    out[i] = y[(((b * hs + (fm >> 1)) * ws + (fn >> 1)) * 4 + ((fm & 1) * 2 + (fn & 1))) * cw + c];
  }
}

constexpr int kMaxDevices = 64;

// The current device's SM count, asked once per device: the launch is on
// the host's critical path at batch 1.
int sm_count(int* sms) {
  static int known[kMaxDevices] = {};
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (dev < kMaxDevices && known[dev] > 0) {
    *sms = known[dev];
    return 0;
  }
  rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess && dev < kMaxDevices) known[dev] = *sms;
  return static_cast<int>(rc);
}

template <typename Word>
int launch(const void* y, void* out, long long batch, int hs, int ws, int cw, int pw, int hp,
           cudaStream_t stream) {
  const long long total = batch * hp * (ws + 3) * static_cast<long long>(pw);
  if (total == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  int sms = 0;
  const int rc = sm_count(&sms);
  if (rc != 0) return rc;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long max_blocks = 32LL * sms;  // 32 blocks per SM; the loop strides beyond
  if (blocks > max_blocks) blocks = max_blocks;
  s2d_realign_pad3_kernel<Word><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Word*>(y), static_cast<Word*>(out), total, hs, ws, cw, pw, hp);
  return static_cast<int>(cudaGetLastError());
}

// The widest word that divides a tap's bytes, an output pixel's bytes and
// both pointers' alignment. c_out: output channels per pixel (>= 4c).
int dispatch(const void* y, void* out, long long batch, int hs, int ws, int c, int c_out,
             int elt_size, int hp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tap_bytes = static_cast<long long>(c) * elt_size;
  const long long pixel_bytes = static_cast<long long>(c_out) * elt_size;
  const uintptr_t align = reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out);
  for (const int word : {16, 8, 4}) {
    if (tap_bytes % word || pixel_bytes % word || align % word) continue;
    const int cw = static_cast<int>(tap_bytes / word), pw = static_cast<int>(pixel_bytes / word);
    if (word == 16) return launch<uint4>(y, out, batch, hs, ws, cw, pw, hp, s);
    if (word == 8) return launch<uint2>(y, out, batch, hs, ws, cw, pw, hp, s);
    return launch<uint32_t>(y, out, batch, hs, ws, cw, pw, hp, s);
  }
  if (elt_size == 2) return launch<uint16_t>(y, out, batch, hs, ws, c, c_out, hp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// -- K2 ----------------------------------------------------------------------

// n / d for 0 <= n < 2^31 as (umulhi(n, mul) >> shr), d fixed per launch
// (the round-up multiplier of Granlund and Montgomery; mul = 0 for d = 1).
// Mirrored by jpdse_tpu_torch/ops/realign.py::_fast_div.
struct FastDiv {
  uint32_t d, mul, shr;
};

FastDiv make_fast_div(uint32_t d) {
  FastDiv f{d, 0, 0};
  if (d > 1) {
    uint32_t l = 0;
    while ((1u << l) < d) ++l;  // ceil(log2 d)
    f.mul = static_cast<uint32_t>(((1ull << (31 + l)) + d - 1) / d);
    f.shr = l - 1;
  }
  return f;
}

__device__ __forceinline__ int fast_div(int n, FastDiv f) {
  return f.d == 1 ? n : static_cast<int>(__umulhi(static_cast<uint32_t>(n), f.mul) >> f.shr);
}

// 16 bytes from device memory to shared memory without a trip through
// registers: a thread starts all its loads before any arrives.
__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

constexpr int kFrontThreads = 256;
constexpr int kFrontTileBytes = 16384;  // output bytes a block aims at

// One block per tile of `tk` output pixels of one output row (b, j); tiles
// of a row are consecutive blocks. buf: elements of shared memory for each
// staged source row. jpdse_tpu_torch/ops/realign.py::_front_plan,
// _front_block, _front_wide and _front_gather mirror the plan and the index
// math, and tests/test_torch_port_front_plan.py emulates the loads and
// stores.
template <typename T>
__global__ void __launch_bounds__(kFrontThreads)
    s2d_pad3_front_kernel(const T* __restrict__ x, T* __restrict__ out, int h, int w, int c,
                          int hp, int tk, int ntiles, int buf, FastDiv div2c) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kE = 16 / sizeof(T);  // elements per 16-byte word
  const int wp = w / 2 + 3;
  const int tile = blockIdx.x % ntiles;  // once per block
  const int row = blockIdx.x / ntiles;
  const int j = row % hp;
  const long long b = row / hp;
  const int k0 = tile * tk, n = min(tk, wp - k0);
  // fine columns the tile reads before reflection, [lo, hi], and the span
  // [s0, s1) that holds every column they reflect to
  const int lo = 2 * k0 - 3, hi = 2 * (k0 + n - 1) - 2;
  const int s0 = max(0, min(lo, 2 * (w - 1) - hi)), s1 = min(w, max(hi, -lo) + 1);
  const int span = (s1 - s0) * c;
  T* rows = reinterpret_cast<T*>(smem);
  int shift0 = 0, shift1 = 0;  // element offset of column s0 in each staged row
  for (int p = 0; p < 2; ++p) {
    const T* src = x + ((b * h + reflect(2 * j - 3 + p, h)) * w + s0) * c;
    const T* base = reinterpret_cast<const T*>(reinterpret_cast<uintptr_t>(src) & ~uintptr_t{15});
    const int shift = static_cast<int>(src - base);
    T* dst = rows + p * buf;
    const int words = (shift + span + kE - 1) / kE;
    for (int i = threadIdx.x; i < words; i += kFrontThreads) {
      const int e0 = i * kE;
      if (e0 >= shift && e0 + kE <= shift + span) {
        copy_async16(dst + e0, base + e0);
      } else {  // the first or last word: only its elements inside the span
        for (int q = 0; q < kE; ++q) {
          if (e0 + q >= shift && e0 + q < shift + span) dst[e0 + q] = base[e0 + q];
        }
      }
    }
    (p ? shift1 : shift0) = shift;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // output element e of the tile: chunk t = e / 2C of 2C elements, from row
  // p = t & 1 of output pixel k = k0 + t / 2; its tap pv = (o >= C) reads
  // fine column reflect(2k - 3 + pv)
  const int c2 = 2 * c;
  auto gather = [&](int t, int o) -> T {
    const int p = t & 1, k = k0 + (t >> 1), pv = o >= c;
    const int col = reflect(2 * k - 3 + pv, w);
    return rows[p * buf + (p ? shift1 : shift0) + (col - s0) * c + o - pv * c];
  };
  T* dst = out + ((b * hp + j) * wp + k0) * 4LL * c;
  const int m = n * 2 * c2;
  const int head = min(m, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) /
                              static_cast<int>(sizeof(T)));
  const int body = (m - head) / kE;
  // where 2C is a whole number of words, words and chunks line up and most
  // words take the wide read; elsewhere few would, and a warp would run both
  // paths, so none does
  const bool wide = c2 % kE == 0;
  for (int i = threadIdx.x; i < body; i += kFrontThreads) {
    const int e = head + i * kE;
    int t = fast_div(e, div2c), o = e - t * c2;
    union {
      uint4 word;
      uint2 w8[2];
      uint32_t w4[4];
      T el[kE];
    } v;
    const int k = k0 + (t >> 1);
    if (wide && o + kE <= c2 && k >= 2 && 2 * k - 2 < w) {
      // inside one chunk of a pixel whose columns do not reflect: kE
      // consecutive staged elements, read as wide as their alignment allows
      const int p = t & 1;
      const T* s = rows + p * buf + (p ? shift1 : shift0) + (2 * k - 3 - s0) * c + o;
      const uintptr_t a = reinterpret_cast<uintptr_t>(s);
      if ((a & 7) == 0) {
        v.w8[0] = reinterpret_cast<const uint2*>(s)[0];
        v.w8[1] = reinterpret_cast<const uint2*>(s)[1];
      } else if ((a & 3) == 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) v.w4[q] = reinterpret_cast<const uint32_t*>(s)[q];
      } else {
#pragma unroll
        for (int q = 0; q < kE; ++q) v.el[q] = s[q];
      }
    } else {
#pragma unroll
      for (int q = 0; q < kE; ++q) {
        v.el[q] = gather(t, o);
        if (++o == c2) {
          o = 0;
          ++t;
        }
      }
    }
    reinterpret_cast<uint4*>(dst + e)[0] = v.word;
  }
  const int tail = m - head - body * kE;
  if (threadIdx.x < head + tail) {  // the unaligned first and last elements
    const int e = threadIdx.x < head ? threadIdx.x : head + body * kE + (threadIdx.x - head);
    const int t = fast_div(e, div2c);
    dst[e] = gather(t, e - t * c2);
  }
}

template <typename T>
int launch_front(const void* x, void* out, long long batch, int h, int w, int c, int hp,
                 cudaStream_t stream) {
  constexpr int kE = 16 / sizeof(T);
  const int wp = w / 2 + 3;
  const long long pixel_bytes = 4LL * c * sizeof(T);
  const int tk = static_cast<int>(
      std::min<long long>(wp, std::max<long long>(1, kFrontTileBytes / pixel_bytes)));
  const int ntiles = (wp + tk - 1) / tk;
  // a staged row: at most max(2 tk, 4) columns, plus the first word's offset
  const long long buf = ((2LL * tk + 4) * c + kE - 1 + kE - 1) / kE * kE;
  const long long smem = 2 * buf * static_cast<long long>(sizeof(T));
  const long long blocks = batch * hp * ntiles;
  if (blocks == 0) return cudaSuccess;
  if (blocks > 0x7fffffffLL || 4LL * c * tk >= (1LL << 31) || smem > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        s2d_pad3_front_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  s2d_pad3_front_kernel<T><<<static_cast<unsigned>(blocks), kFrontThreads,
                             static_cast<size_t>(smem), stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), h, w, c, hp, tk, ntiles,
      static_cast<int>(buf), make_fast_div(static_cast<uint32_t>(2 * c)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: (batch, hs, ws, 4c) contiguous; out: (batch, hp, ws + 3, c_out)
// contiguous, hp = hs + 3 + extra_rows, c_out >= 4c (channels past 4c are
// written as zeros), allocated by the caller. elt_size is 2 or 4. Returns a
// cudaError_t: 0 when the launch was accepted.
extern "C" int s2d_realign_pad3_launch(const void* y, void* out, long long batch, int hs, int ws,
                                       int c, int elt_size, int hp, int c_out, void* stream) {
  if (hs < 2 || ws < 2 || c < 1 || hp < hs + 3 || 2 * hp - 3 > 2 * (2 * hs - 1) + 1 ||
      c_out < 4 * c || (elt_size != 2 && elt_size != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return dispatch(y, out, batch, hs, ws, c, c_out, elt_size, hp, stream);
}

// K2. x: (batch, h, w, c) contiguous, h and w even and >= 4; out: (batch,
// hp, w/2 + 3, 4c) contiguous, hp = h/2 + 3 + extra_rows, allocated by the
// caller. elt_size is 2 or 4. Returns a cudaError_t: 0 when the launch was
// accepted.
extern "C" int s2d_pad3_launch(const void* x, void* out, long long batch, int h, int w, int c,
                               int elt_size, int hp, void* stream) {
  if (h < 4 || w < 4 || h % 2 || w % 2 || c < 1 || hp < h / 2 + 3 ||
      2 * hp - 3 > 2 * (h - 1) + 1 || (elt_size != 2 && elt_size != 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elt_size == 2) return launch_front<uint16_t>(x, out, batch, h, w, c, hp, s);
  return launch_front<uint32_t>(x, out, batch, h, w, c, hp, s);
}
