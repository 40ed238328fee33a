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
// bf16 reads 3.1 MB and writes 3.2 MB: about 1.9 us.
//
// Design: one thread per word of output in a grid-stride loop, the word
// being the widest of 16, 8 or 4 bytes that divides a tap's C channels
// when both pointers are aligned to it, else one element. Neighbouring
// threads write neighbouring words of an output row, and each tap's C
// channels are contiguous in the source too, so loads and stores are
// coalesced within a tap. The fronts' C = 3, 36 and 39 fill no 16-byte
// word and take the narrower words. Making them fast is later work: stage
// rows through shared memory or TMA, and read each source row once for
// both taps of a `pu` pair.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ int reflect(int m, int n) {
  m = m < 0 ? -m : m;
  return m > n - 1 ? 2 * (n - 1) - m : m;
}

// Word is the unit moved: uint4, uint2, uint32_t or one element.
// cw: words per tap (C * element size / sizeof(Word)); pw: words per output
// pixel (>= 4*cw; words past 4*cw are zero padding); hp: output rows.
// kFront: K2 (fine source of hs*2 x ws*2 pixels) rather than K1 (s2d source
// of hs x ws).
template <typename Word, bool kFront>
__global__ void s2d_pad3_kernel(const Word* __restrict__ y, Word* __restrict__ out,
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
    const long long src =
        kFront ? ((b * 2 * hs + fm) * 2 * ws + fn) * cw + c
               : (((b * hs + (fm >> 1)) * ws + (fn >> 1)) * 4 + ((fm & 1) * 2 + (fn & 1))) * cw + c;
    out[i] = y[src];
  }
}

template <typename Word, bool kFront>
int launch(const void* y, void* out, long long batch, int hs, int ws, int cw, int pw, int hp,
           cudaStream_t stream) {
  const long long total = batch * hp * (ws + 3) * static_cast<long long>(pw);
  if (total == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long kMaxBlocks = 132LL * 32;  // 32 blocks per SM; the loop strides beyond
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  s2d_pad3_kernel<Word, kFront><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Word*>(y), static_cast<Word*>(out), total, hs, ws, cw, pw, hp);
  return static_cast<int>(cudaGetLastError());
}

// The widest word that divides a tap's bytes, an output pixel's bytes and
// both pointers' alignment. c_out: output channels per pixel (>= 4c).
template <bool kFront>
int dispatch(const void* y, void* out, long long batch, int hs, int ws, int c, int c_out,
             int elt_size, int hp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tap_bytes = static_cast<long long>(c) * elt_size;
  const long long pixel_bytes = static_cast<long long>(c_out) * elt_size;
  const uintptr_t align = reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out);
  for (const int word : {16, 8, 4}) {
    if (tap_bytes % word || pixel_bytes % word || align % word) continue;
    const int cw = static_cast<int>(tap_bytes / word), pw = static_cast<int>(pixel_bytes / word);
    if (word == 16) return launch<uint4, kFront>(y, out, batch, hs, ws, cw, pw, hp, s);
    if (word == 8) return launch<uint2, kFront>(y, out, batch, hs, ws, cw, pw, hp, s);
    return launch<uint32_t, kFront>(y, out, batch, hs, ws, cw, pw, hp, s);
  }
  if (elt_size == 2) return launch<uint16_t, kFront>(y, out, batch, hs, ws, c, c_out, hp, s);
  return static_cast<int>(cudaErrorInvalidValue);
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
  return dispatch<false>(y, out, batch, hs, ws, c, c_out, elt_size, hp, stream);
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
  return dispatch<true>(x, out, batch, h / 2, w / 2, c, 4 * c, elt_size, hp, stream);
}
