// Native dataset runtime: threaded PNG decoding with ordered prefetch.
//
// The equivalent of the reference's host-side data path (the
// per-frame cv::imread calls in Examples/*/ *.cc, e.g.
// multi_inertial_euroc.cc:148-176): a pool of decoder threads fills a
// fixed-capacity ring of frame slots ahead of the consumer, so image
// decode overlaps device compute. C API consumed via ctypes.
//
// Build: g++ -O3 -shared -fPIC loader.cpp -lpng -o libomv_loader.so

#include <png.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// PNG decode (grayscale 8-bit output, any input layout)
// ---------------------------------------------------------------------------

bool decode_png_gray(const char* path, std::vector<uint8_t>* out,
                     int* out_w, int* out_h) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return false;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) {
    std::fclose(fp);
    return false;
  }
  png_infop info = png_create_info_struct(png);
  if (!info || setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    std::fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);

  png_uint_32 w = png_get_image_width(png, info);
  png_uint_32 h = png_get_image_height(png, info);
  int color = png_get_color_type(png, info);
  int depth = png_get_bit_depth(png, info);

  // normalize everything to 8-bit gray
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA ||
      color == PNG_COLOR_TYPE_PALETTE)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);

  out->resize(size_t(w) * h);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out->data() + size_t(y) * w;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  std::fclose(fp);
  *out_w = int(w);
  *out_h = int(h);
  return true;
}

// ---------------------------------------------------------------------------
// Ordered prefetch stream
// ---------------------------------------------------------------------------

struct Slot {
  std::vector<uint8_t> data;
  int status = 0;  // 0 empty, 1 ready, -1 failed
  int frame = -1;
};

struct Stream {
  std::vector<std::string> paths;
  int w = 0, h = 0;
  int capacity = 0;
  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits
  std::condition_variable cv_free;    // producers wait
  std::atomic<int> next_claim{0};     // next frame a worker will decode
  int next_consume = 0;               // next frame the consumer expects
  bool closing = false;

  void worker() {
    for (;;) {
      int frame = next_claim.fetch_add(1);
      if (frame >= int(paths.size())) return;
      std::vector<uint8_t> buf;
      int w_ = 0, h_ = 0;
      bool ok = decode_png_gray(paths[frame].c_str(), &buf, &w_, &h_);
      ok = ok && w_ == w && h_ == h;

      std::unique_lock<std::mutex> lk(mu);
      // wait until this frame's slot window is open (stay <= capacity ahead)
      cv_free.wait(lk, [&] {
        return closing || frame < next_consume + capacity;
      });
      if (closing) return;
      Slot& s = slots[frame % capacity];
      s.data = std::move(buf);
      s.status = ok ? 1 : -1;
      s.frame = frame;
      cv_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

int omv_png_decode_gray(const char* path, unsigned char* out, int w, int h) {
  std::vector<uint8_t> buf;
  int w_ = 0, h_ = 0;
  if (!decode_png_gray(path, &buf, &w_, &h_)) return -1;
  if (w_ != w || h_ != h) return -2;
  std::memcpy(out, buf.data(), size_t(w) * h);
  return 0;
}

int omv_png_info(const char* path, int* w, int* h) {
  std::vector<uint8_t> buf;  // full decode: info-only parse omitted for
  return decode_png_gray(path, &buf, w, h) ? 0 : -1;  // simplicity
}

void* omv_stream_open(const char** paths, int n, int w, int h,
                      int n_threads, int capacity) {
  auto* s = new Stream();
  s->paths.assign(paths, paths + n);
  s->w = w;
  s->h = h;
  s->capacity = capacity > 0 ? capacity : 8;
  s->slots.resize(s->capacity);
  int threads = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < threads; ++i)
    s->workers.emplace_back([s] { s->worker(); });
  return s;
}

// Blocks until the next in-order frame is decoded; copies it into `out`
// ([h, w] row-major). Returns the frame index, or -1 past the end, or -2 on
// decode failure.
int omv_stream_next(void* handle, unsigned char* out) {
  auto* s = static_cast<Stream*>(handle);
  std::unique_lock<std::mutex> lk(s->mu);
  int frame = s->next_consume;
  if (frame >= int(s->paths.size())) return -1;
  Slot& slot = s->slots[frame % s->capacity];
  s->cv_ready.wait(lk, [&] { return slot.frame == frame && slot.status != 0; });
  int status = slot.status;
  if (status == 1)
    std::memcpy(out, slot.data.data(), size_t(s->w) * s->h);
  slot.status = 0;
  slot.frame = -1;
  s->next_consume++;
  s->cv_free.notify_all();
  return status == 1 ? frame : -2;
}

void omv_stream_close(void* handle) {
  auto* s = static_cast<Stream*>(handle);
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->closing = true;
  }
  s->cv_free.notify_all();
  s->cv_ready.notify_all();
  s->next_claim.store(int(s->paths.size()));
  for (auto& t : s->workers) t.join();
  delete s;
}

}  // extern "C"
