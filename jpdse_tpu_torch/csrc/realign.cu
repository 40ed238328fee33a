// Grid re-alignment of a space-to-depth tensor, for Hopper (sm_90a).
//
// Replaces jpdse_tpu/ops/pallas/realign.py::s2d_realign_pad3_pallas (K1):
// out = space_to_depth(reflect_pad(depth_to_space(y), 3)), with `extra_rows`
// further rows of deeper reflection, mapping (B, hs, ws, 4C) to
// (B, hs + 3 + extra_rows, ws + 3, 4C). Elements are only moved, so the
// result is bit-exact and the kernel is the same for 2- and 4-byte types.
//
// Index map: output element (b, j, k, (pu*2 + pv)*C + c) is fine pixel
// (fm, fn) = (r(2j + pu - 3), r(2k + pv - 3)) of depth_to_space(y), where r
// reflects once into [0, 2hs) or [0, 2ws); it is read from
// y[b, fm/2, fn/2, ((fm%2)*2 + fn%2)*C + c]. The Python mirror of this
// arithmetic is jpdse_tpu_torch/ops/realign.py::_source_index.
//
// Bound: device-memory bytes. At the flagship's (1, 256, 512, 256) bf16 it
// reads 67.1 MB and writes 68.3 MB: 135.4 MB / 3.35 TB/s, about 40 us per
// launch (about 81 us in fp32).
//
// Design: one thread per 16-byte word of output when a tap's C channels
// fill whole 16-byte words and both pointers are 16-byte aligned, one per
// element otherwise, in a grid-stride loop. Neighbouring threads write
// neighbouring words of an output row, and each tap's C channels are
// contiguous in the source too, so loads and stores are coalesced within a
// tap. Making it fast is later work: stage rows through shared memory or
// TMA, and read each source row once for both taps of a `pu` pair.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ int reflect(int m, int n) {
  m = m < 0 ? -m : m;
  return m > n - 1 ? 2 * (n - 1) - m : m;
}

// Word is the unit moved: uint4 (16 bytes), uint32_t or uint16_t.
// cw: words per tap (C * element size / sizeof(Word)); hp: output rows.
template <typename Word>
__global__ void s2d_realign_pad3_kernel(const Word* __restrict__ y, Word* __restrict__ out,
                                        long long total, int hs, int ws, int cw, int hp) {
  const int wp = ws + 3;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += step) {
    long long t = i;
    const int c = static_cast<int>(t % cw);
    t /= cw;
    const int tap = static_cast<int>(t % 4);
    t /= 4;
    const int k = static_cast<int>(t % wp);
    t /= wp;
    const int j = static_cast<int>(t % hp);
    const long long b = t / hp;
    const int fm = reflect(2 * j + (tap >> 1) - 3, 2 * hs);
    const int fn = reflect(2 * k + (tap & 1) - 3, 2 * ws);
    const long long src =
        (((b * hs + (fm >> 1)) * ws + (fn >> 1)) * 4 + ((fm & 1) * 2 + (fn & 1))) * cw + c;
    out[i] = y[src];
  }
}

template <typename Word>
int launch(const void* y, void* out, long long batch, int hs, int ws, int cw, int hp,
           cudaStream_t stream) {
  const long long total = batch * hp * (ws + 3) * 4LL * cw;
  if (total == 0) return cudaSuccess;
  constexpr int kThreads = 256;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long kMaxBlocks = 132LL * 32;  // 32 blocks per SM; the loop strides beyond
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  s2d_realign_pad3_kernel<Word><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const Word*>(y), static_cast<Word*>(out), total, hs, ws, cw, hp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: (batch, hs, ws, 4c) contiguous; out: (batch, hp, ws + 3, 4c) contiguous,
// hp = hs + 3 + extra_rows, allocated by the caller. elt_size is 2 or 4.
// Returns a cudaError_t: 0 when the launch was accepted.
extern "C" int s2d_realign_pad3_launch(const void* y, void* out, long long batch, int hs, int ws,
                                       int c, int elt_size, int hp, void* stream) {
  if (hs < 2 || ws < 2 || c < 1 || hp < hs + 3 || 2 * hp - 3 > 2 * (2 * hs - 1) + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tap_bytes = static_cast<long long>(c) * elt_size;
  const bool aligned = reinterpret_cast<uintptr_t>(y) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (tap_bytes % 16 == 0 && aligned) {
    return launch<uint4>(y, out, batch, hs, ws, static_cast<int>(tap_bytes / 16), hp, s);
  }
  if (elt_size == 4) return launch<uint32_t>(y, out, batch, hs, ws, c, hp, s);
  if (elt_size == 2) return launch<uint16_t>(y, out, batch, hs, ws, c, hp, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
