// Adaptive binary range-coder core (LZMA-family construction,
// public-domain algorithmics): 32-bit range, 11-bit adaptive probabilities,
// shift-5 adaptation. Used by range_coder.cpp (binarized bottleneck codes)
// and idmap_coder.cpp (lossless semantic and instance id maps).
// The port's own copy of jpdse_tpu/native/rc_core.h, unchanged in its
// arithmetic: the .jpds streams of the two packages must be byte-identical.
#ifndef JPDSE_RC_CORE_H_
#define JPDSE_RC_CORE_H_

#include <cstdint>

namespace jpdse_rc {

constexpr uint32_t kTopBits = 24;
constexpr uint32_t kTop = 1u << kTopBits;
constexpr uint32_t kProbBits = 11;
constexpr uint32_t kProbMax = 1u << kProbBits;  // 2048
constexpr uint32_t kProbInit = kProbMax / 2;
constexpr uint32_t kAdaptShift = 5;

class Encoder {
 public:
  explicit Encoder(uint8_t* out, int64_t cap) : out_(out), cap_(cap) {}

  bool put(uint16_t& prob, int bit) {
    uint32_t bound = (range_ >> kProbBits) * prob;
    if (bit == 0) {
      range_ = bound;
      prob += (kProbMax - prob) >> kAdaptShift;
    } else {
      low_ += bound;
      range_ -= bound;
      prob -= prob >> kAdaptShift;
    }
    while (range_ < kTop) {
      if (!shift_low()) return false;
      range_ <<= 8;
    }
    return true;
  }

  bool flush() {
    for (int i = 0; i < 5; ++i)
      if (!shift_low()) return false;
    return true;
  }

  int64_t size() const { return pos_; }
  bool overflowed() const { return overflow_; }

 private:
  bool emit(uint8_t b) {
    if (pos_ >= cap_) {
      overflow_ = true;
      return false;
    }
    out_[pos_++] = b;
    return true;
  }

  bool shift_low() {
    // carry-counting byte output (the stream carries one leading zero byte
    // from cache_size_ starting at 1; the decoder primes with 5 bytes)
    if (static_cast<uint32_t>(low_) < 0xFF000000u || (low_ >> 32) != 0) {
      uint8_t carry = static_cast<uint8_t>(low_ >> 32);
      uint8_t temp = cache_;
      do {
        if (!emit(static_cast<uint8_t>(temp + carry))) return false;
        temp = 0xFF;
      } while (--cache_size_ > 0);
      cache_ = static_cast<uint8_t>(low_ >> 24);
    }
    ++cache_size_;
    low_ = (low_ & 0x00FFFFFFull) << 8;
    return true;
  }

  uint8_t* out_;
  int64_t cap_;
  int64_t pos_ = 0;
  uint64_t low_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
  uint8_t cache_ = 0;
  int64_t cache_size_ = 1;
  bool overflow_ = false;
};

class Decoder {
 public:
  Decoder(const uint8_t* in, int64_t size) : in_(in), size_(size) {
    for (int i = 0; i < 5; ++i) code_ = (code_ << 8) | next();
  }

  int get(uint16_t& prob) {
    uint32_t bound = (range_ >> kProbBits) * prob;
    int bit;
    if (code_ < bound) {
      range_ = bound;
      prob += (kProbMax - prob) >> kAdaptShift;
      bit = 0;
    } else {
      code_ -= bound;
      range_ -= bound;
      prob -= prob >> kAdaptShift;
      bit = 1;
    }
    while (range_ < kTop) {
      range_ <<= 8;
      code_ = (code_ << 8) | next();
    }
    return bit;
  }

 private:
  uint8_t next() { return pos_ < size_ ? in_[pos_++] : 0; }

  const uint8_t* in_;
  int64_t size_;
  int64_t pos_ = 0;
  uint32_t code_ = 0;
  uint32_t range_ = 0xFFFFFFFFu;
};

}  // namespace jpdse_rc

#endif  // JPDSE_RC_CORE_H_
