// In-process HEVC-intra image codec (libheif with x265 / de265): the port's
// own copy of jpdse_tpu/native/heif_codec.cpp. BPG is HEVC intra coding and
// HEIF is HEVC intra in the ISO-BMFF container, so this is the base codec of
// the paper's recipe with an in-memory RGB <-> bitstream interface and no
// subprocess or file round trip.
//
// libheif is resolved with dlopen/dlsym against its public, ABI-stable C API
// (enum values and signatures per the published libheif.h interface), so the
// build needs no headers and links only -ldl. Where libheif or its HEVC
// plugins are absent, jpdse_heif_available() returns 0 and the Python side
// raises CodecUnavailable.

#include <cstdint>
#include <cstring>
#include <dlfcn.h>
#include <mutex>
#include <vector>

namespace {

// ---- minimal libheif ABI declarations (public API) ----
struct heif_error {
  int code;
  int subcode;
  const char* message;
};

struct heif_writer {
  int writer_api_version;
  heif_error (*write)(void* ctx, const void* data, size_t size, void* userdata);
};

enum {
  HEIF_COMPRESSION_HEVC = 1,
  HEIF_COLORSPACE_RGB = 1,
  HEIF_CHROMA_INTERLEAVED_RGB = 10,
  HEIF_CHANNEL_INTERLEAVED = 10,
};

struct Api {
  void* (*context_alloc)();
  void (*context_free)(void*);
  heif_error (*context_get_encoder_for_format)(void*, int, void**);
  void (*encoder_release)(void*);
  heif_error (*encoder_set_lossy_quality)(void*, int);
  heif_error (*encoder_set_parameter_string)(void*, const char*, const char*);
  heif_error (*image_create)(int, int, int, int, void**);
  heif_error (*image_add_plane)(void*, int, int, int, int);
  uint8_t* (*image_get_plane)(void*, int, int*);
  const uint8_t* (*image_get_plane_readonly)(void*, int, int*);
  void (*image_release)(void*);
  heif_error (*context_encode_image)(void*, const void*, void*, const void*, void**);
  void (*image_handle_release)(void*);
  heif_error (*context_write)(void*, heif_writer*, void*);
  heif_error (*context_read_from_memory_without_copy)(void*, const void*, size_t, const void*);
  heif_error (*context_get_primary_image_handle)(void*, void**);
  int (*image_handle_get_width)(const void*);
  int (*image_handle_get_height)(const void*);
  heif_error (*decode_image)(const void*, void**, int, int, const void*);
  int (*have_decoder_for_format)(int);

  bool ok = false;
};

Api g_api;
std::once_flag g_once;

void load_api() {
  void* lib = dlopen("libheif.so.1", RTLD_NOW | RTLD_GLOBAL);
  if (!lib) lib = dlopen("libheif.so", RTLD_NOW | RTLD_GLOBAL);
  if (!lib) return;
  auto sym = [&](const char* name) { return dlsym(lib, name); };
#define LOAD(field, name)                                        \
  g_api.field = reinterpret_cast<decltype(g_api.field)>(sym(name)); \
  if (!g_api.field) return;
  LOAD(context_alloc, "heif_context_alloc")
  LOAD(context_free, "heif_context_free")
  LOAD(context_get_encoder_for_format, "heif_context_get_encoder_for_format")
  LOAD(encoder_release, "heif_encoder_release")
  LOAD(encoder_set_lossy_quality, "heif_encoder_set_lossy_quality")
  LOAD(encoder_set_parameter_string, "heif_encoder_set_parameter_string")
  LOAD(image_create, "heif_image_create")
  LOAD(image_add_plane, "heif_image_add_plane")
  LOAD(image_get_plane, "heif_image_get_plane")
  LOAD(image_get_plane_readonly, "heif_image_get_plane_readonly")
  LOAD(image_release, "heif_image_release")
  LOAD(context_encode_image, "heif_context_encode_image")
  LOAD(image_handle_release, "heif_image_handle_release")
  LOAD(context_write, "heif_context_write")
  LOAD(context_read_from_memory_without_copy, "heif_context_read_from_memory_without_copy")
  LOAD(context_get_primary_image_handle, "heif_context_get_primary_image_handle")
  LOAD(image_handle_get_width, "heif_image_handle_get_width")
  LOAD(image_handle_get_height, "heif_image_handle_get_height")
  LOAD(decode_image, "heif_decode_image")
  LOAD(have_decoder_for_format, "heif_have_decoder_for_format")
#undef LOAD
  g_api.ok = true;
}

const Api& api() {
  std::call_once(g_once, load_api);
  return g_api;
}

heif_error collect_write(void*, const void* data, size_t size, void* userdata) {
  auto* buf = static_cast<std::vector<uint8_t>*>(userdata);
  const auto* p = static_cast<const uint8_t*>(data);
  buf->insert(buf->end(), p, p + size);
  return heif_error{0, 0, "ok"};
}

}  // namespace

extern "C" {

// 1 when libheif + an HEVC encoder + decoder are usable.
int jpdse_heif_available() {
  const Api& a = api();
  if (!a.ok) return 0;
  void* ctx = a.context_alloc();
  if (!ctx) return 0;
  void* enc = nullptr;
  heif_error e = a.context_get_encoder_for_format(ctx, HEIF_COMPRESSION_HEVC, &enc);
  int ok = (e.code == 0 && enc != nullptr && a.have_decoder_for_format(HEIF_COMPRESSION_HEVC));
  if (enc) a.encoder_release(enc);
  a.context_free(ctx);
  return ok;
}

// Encode interleaved RGB (h, w, 3) -> HEIF/HEVC bitstream in out (cap bytes).
// quality in [0, 100] (x265 lossy quality; the BPG-equivalent knob).
// preset: x265 speed preset string (e.g. "fast", "medium"); NULL = default.
// Returns bitstream size, or -1 on error / -2 if cap too small.
int64_t jpdse_heif_encode(const uint8_t* rgb, int w, int h, int quality,
                          const char* preset, uint8_t* out, int64_t cap) {
  const Api& a = api();
  if (!a.ok) return -1;
  void* ctx = a.context_alloc();
  if (!ctx) return -1;
  void* enc = nullptr;
  void* img = nullptr;
  void* handle = nullptr;
  int64_t result = -1;
  std::vector<uint8_t> buf;
  do {
    if (a.context_get_encoder_for_format(ctx, HEIF_COMPRESSION_HEVC, &enc).code) break;
    if (a.encoder_set_lossy_quality(enc, quality).code) break;
    if (preset && preset[0]) a.encoder_set_parameter_string(enc, "preset", preset);
    if (a.image_create(w, h, HEIF_COLORSPACE_RGB, HEIF_CHROMA_INTERLEAVED_RGB, &img).code)
      break;
    if (a.image_add_plane(img, HEIF_CHANNEL_INTERLEAVED, w, h, 8).code) break;
    int stride = 0;
    uint8_t* plane = a.image_get_plane(img, HEIF_CHANNEL_INTERLEAVED, &stride);
    if (!plane) break;
    for (int y = 0; y < h; ++y)
      std::memcpy(plane + static_cast<int64_t>(y) * stride, rgb + static_cast<int64_t>(y) * w * 3,
                  static_cast<size_t>(w) * 3);
    if (a.context_encode_image(ctx, img, enc, nullptr, &handle).code) break;
    heif_writer writer{1, &collect_write};
    if (a.context_write(ctx, &writer, &buf).code) break;
    if (static_cast<int64_t>(buf.size()) > cap) {
      result = -2;
      break;
    }
    std::memcpy(out, buf.data(), buf.size());
    result = static_cast<int64_t>(buf.size());
  } while (false);
  if (handle) a.image_handle_release(handle);
  if (img) a.image_release(img);
  if (enc) a.encoder_release(enc);
  a.context_free(ctx);
  return result;
}

// Decode a HEIF/HEVC bitstream into interleaved RGB (h, w, 3) written to out
// (cap bytes). Returns 0 on success and fills *out_w/*out_h; -1 on error;
// -2 if cap too small.
int64_t jpdse_heif_decode(const uint8_t* data, int64_t size, uint8_t* out,
                          int64_t cap, int* out_w, int* out_h) {
  const Api& a = api();
  if (!a.ok) return -1;
  void* ctx = a.context_alloc();
  if (!ctx) return -1;
  void* handle = nullptr;
  void* img = nullptr;
  int64_t result = -1;
  do {
    if (a.context_read_from_memory_without_copy(ctx, data, static_cast<size_t>(size), nullptr)
            .code)
      break;
    if (a.context_get_primary_image_handle(ctx, &handle).code) break;
    int w = a.image_handle_get_width(handle);
    int h = a.image_handle_get_height(handle);
    if (a.decode_image(handle, &img, HEIF_COLORSPACE_RGB, HEIF_CHROMA_INTERLEAVED_RGB, nullptr)
            .code)
      break;
    if (static_cast<int64_t>(w) * h * 3 > cap) {
      // report the needed dimensions so the caller can retry with the
      // exact buffer size (high-ratio streams can exceed any fixed guess)
      *out_w = w;
      *out_h = h;
      result = -2;
      break;
    }
    int stride = 0;
    const uint8_t* plane = a.image_get_plane_readonly(img, HEIF_CHANNEL_INTERLEAVED, &stride);
    if (!plane) break;
    for (int y = 0; y < h; ++y)
      std::memcpy(out + static_cast<int64_t>(y) * w * 3, plane + static_cast<int64_t>(y) * stride,
                  static_cast<size_t>(w) * 3);
    *out_w = w;
    *out_h = h;
    result = 0;
  } while (false);
  if (img) a.image_release(img);
  if (handle) a.image_handle_release(handle);
  a.context_free(ctx);
  return result;
}

}  // extern "C"
