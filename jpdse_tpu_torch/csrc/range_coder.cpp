// Adaptive binary range coder for the codec's binarized bottleneck codes.
//
// The reference never implements entropy coding: it dumps one raw byte per
// bit (test.py:98-110) and only *estimates* the post-entropy-coding rate via
// a Bernoulli Shannon bound (pix2pixHD_model.py:480-489). This coder closes
// that gap: it produces an actual bitstream whose size approaches (and with
// per-channel contexts, beats) that scalar bound.
//
// The coder core (carry-counting binary range coder) lives in rc_core.h.
// Optional context ids give each bit its own adaptive model (e.g. one per
// bottleneck channel).
//
// The port's own copy of jpdse_tpu/native/range_coder.cpp (its four
// jpdse_rc_* functions, unchanged), built with g++ by
// jpdse_tpu_torch/ops/build.py into a library with a plain C interface and
// bound by jpdse_tpu_torch/native.py. It runs on the host: the serial
// adaptive models leave nothing for the card to do in parallel.

#include <cstdint>
#include <cstring>
#include <vector>

#include "rc_core.h"

using jpdse_rc::Decoder;
using jpdse_rc::Encoder;
using jpdse_rc::kProbInit;

extern "C" {

// Encode n bits (values 0/1). ctx may be null (single adaptive model) or an
// array of n context ids in [0, n_ctx). Returns the bitstream size in bytes,
// or -1 if out_cap was too small.
int64_t jpdse_rc_encode(const uint8_t* bits, int64_t n, const int32_t* ctx,
                        int32_t n_ctx, uint8_t* out, int64_t out_cap) {
  if (n_ctx <= 0) n_ctx = 1;
  std::vector<uint16_t> probs(static_cast<size_t>(n_ctx), kProbInit);
  Encoder enc(out, out_cap);
  for (int64_t i = 0; i < n; ++i) {
    int32_t c = ctx ? ctx[i] : 0;
    if (c < 0 || c >= n_ctx) c = 0;
    if (!enc.put(probs[static_cast<size_t>(c)], bits[i] != 0)) return -1;
  }
  if (!enc.flush()) return -1;
  return enc.size();
}

// Spatial-context coding for (h, w, c)-shaped binary code planes — the
// bottleneck codes of the learned configurations, whose bits are spatially
// correlated (the id-map coder proved neighbor contexts pay 2-4x on this
// data family; the reference only ever *estimated* rate with a context-free
// Bernoulli bound, pix2pixHD_model.py:480-489). ``bits`` is the
// concatenation of per-code NHWC rasters (the .jpds payload layout);
// ``shapes`` is n_codes * (h, w, c). Each bit's adaptive model is selected
// by (code, channel, left-neighbor bit, up-neighbor bit): context =
// code_base + ch*4 + 2*left + up, missing neighbors treated as 0. The
// decoder reconstructs the identical context stream from its own decoded
// output (left/up precede every bit in raster order), so no side info is
// needed beyond the shapes already in the .jpds header.
int64_t jpdse_rc_encode_spatial(const uint8_t* bits, const int32_t* shapes,
                                int32_t n_codes, uint8_t* out,
                                int64_t out_cap) {
  int64_t n_ctx = 0;
  for (int32_t k = 0; k < n_codes; ++k) n_ctx += 4 * shapes[3 * k + 2];
  if (n_ctx <= 0) n_ctx = 1;
  std::vector<uint16_t> probs(static_cast<size_t>(n_ctx), kProbInit);
  Encoder enc(out, out_cap);
  int64_t pos = 0, base = 0;
  for (int32_t k = 0; k < n_codes; ++k) {
    const int64_t h = shapes[3 * k], w = shapes[3 * k + 1],
                  c = shapes[3 * k + 2];
    const uint8_t* blk = bits + pos;
    for (int64_t y = 0; y < h; ++y) {
      for (int64_t x = 0; x < w; ++x) {
        for (int64_t ch = 0; ch < c; ++ch) {
          const int64_t i = (y * w + x) * c + ch;
          const int left = x > 0 ? blk[i - c] != 0 : 0;
          const int up = y > 0 ? blk[i - w * c] != 0 : 0;
          const int64_t ctx = base + ch * 4 + 2 * left + up;
          if (!enc.put(probs[static_cast<size_t>(ctx)], blk[i] != 0))
            return -1;
        }
      }
    }
    pos += h * w * c;
    base += 4 * c;
  }
  if (!enc.flush()) return -1;
  return enc.size();
}

int64_t jpdse_rc_decode_spatial(const uint8_t* data, int64_t size,
                                const int32_t* shapes, int32_t n_codes,
                                uint8_t* bits) {
  int64_t n_ctx = 0;
  for (int32_t k = 0; k < n_codes; ++k) n_ctx += 4 * shapes[3 * k + 2];
  if (n_ctx <= 0) n_ctx = 1;
  std::vector<uint16_t> probs(static_cast<size_t>(n_ctx), kProbInit);
  Decoder dec(data, size);
  int64_t pos = 0, base = 0;
  for (int32_t k = 0; k < n_codes; ++k) {
    const int64_t h = shapes[3 * k], w = shapes[3 * k + 1],
                  c = shapes[3 * k + 2];
    uint8_t* blk = bits + pos;
    for (int64_t y = 0; y < h; ++y) {
      for (int64_t x = 0; x < w; ++x) {
        for (int64_t ch = 0; ch < c; ++ch) {
          const int64_t i = (y * w + x) * c + ch;
          const int left = x > 0 ? blk[i - c] != 0 : 0;
          const int up = y > 0 ? blk[i - w * c] != 0 : 0;
          const int64_t ctx = base + ch * 4 + 2 * left + up;
          blk[i] = static_cast<uint8_t>(
              dec.get(probs[static_cast<size_t>(ctx)]));
        }
      }
    }
    pos += h * w * c;
    base += 4 * c;
  }
  return pos;
}

// Decode n bits from a jpdse_rc_encode bitstream (same ctx layout).
int64_t jpdse_rc_decode(const uint8_t* data, int64_t size, const int32_t* ctx,
                        int32_t n_ctx, uint8_t* bits, int64_t n) {
  if (n_ctx <= 0) n_ctx = 1;
  std::vector<uint16_t> probs(static_cast<size_t>(n_ctx), kProbInit);
  Decoder dec(data, size);
  for (int64_t i = 0; i < n; ++i) {
    int32_t c = ctx ? ctx[i] : 0;
    if (c < 0 || c >= n_ctx) c = 0;
    bits[i] = static_cast<uint8_t>(dec.get(probs[static_cast<size_t>(c)]));
  }
  return n;
}

}  // extern "C"
