// s2v_loader — native runtime pieces for the video pipeline (the port's
// copy of s2v_tpu/io/native/s2v_loader.cpp).
//
// The reference's runtime around the GPU is host-python: cv2.VideoCapture
// loops (facing.py:59-71), per-frame numpy crops + cv2.resize
// (inference.py:292-330). This library provides, in C++:
//
//  1. A threaded ring-buffer clip reader: a producer thread streams raw
//     RGB24 frames from a file (or a pipe fed by ffmpeg) into N
//     preallocated slots while the consumer (the Python thread that feeds
//     the card) drains them, so device steps overlap with video IO.
//  2. uint8 -> float32 crop + bilinear resize with torch
//     `interpolate(align_corners=False)` semantics, so host-prepped tiles
//     agree with device-side math.
//
// Exposed with a plain C ABI for ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// crop + bilinear resize (uint8 HWC -> float32 HWC), torch half-pixel
// convention: src = (dst + 0.5) * scale - 0.5, negative clamped to 0.
// ---------------------------------------------------------------------------
void s2v_crop_resize_u8f32(const uint8_t* src, int64_t src_h, int64_t src_w,
                           int64_t channels, int64_t y0, int64_t y1,
                           int64_t x0, int64_t x1, float* dst, int64_t dst_h,
                           int64_t dst_w, float scale_out) {
  const int64_t ch = y1 - y0;
  const int64_t cw = x1 - x0;
  const double sy = (double)ch / (double)dst_h;
  const double sx = (double)cw / (double)dst_w;

  std::vector<int64_t> xs0(dst_w), xs1(dst_w);
  std::vector<float> xw(dst_w);
  for (int64_t j = 0; j < dst_w; ++j) {
    double s = ((double)j + 0.5) * sx - 0.5;
    if (s < 0) s = 0;
    int64_t i0 = (int64_t)s;
    if (i0 > cw - 1) i0 = cw - 1;
    int64_t i1 = i0 + 1 < cw ? i0 + 1 : cw - 1;
    xs0[j] = i0;
    xs1[j] = i1;
    xw[j] = (float)(s - (double)i0);
  }

  for (int64_t i = 0; i < dst_h; ++i) {
    double s = ((double)i + 0.5) * sy - 0.5;
    if (s < 0) s = 0;
    int64_t r0 = (int64_t)s;
    if (r0 > ch - 1) r0 = ch - 1;
    int64_t r1 = r0 + 1 < ch ? r0 + 1 : ch - 1;
    float wy = (float)(s - (double)r0);

    const uint8_t* row0 = src + ((y0 + r0) * src_w) * channels;
    const uint8_t* row1 = src + ((y0 + r1) * src_w) * channels;
    float* out = dst + i * dst_w * channels;

    for (int64_t j = 0; j < dst_w; ++j) {
      const uint8_t* p00 = row0 + (x0 + xs0[j]) * channels;
      const uint8_t* p01 = row0 + (x0 + xs1[j]) * channels;
      const uint8_t* p10 = row1 + (x0 + xs0[j]) * channels;
      const uint8_t* p11 = row1 + (x0 + xs1[j]) * channels;
      const float wxj = xw[j];
      for (int64_t c = 0; c < channels; ++c) {
        float top = (float)p00[c] + wxj * ((float)p01[c] - (float)p00[c]);
        float bot = (float)p10[c] + wxj * ((float)p11[c] - (float)p10[c]);
        out[j * channels + c] = (top + wy * (bot - top)) * scale_out;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// threaded ring-buffer clip reader
// ---------------------------------------------------------------------------
struct RingLoader {
  FILE* file = nullptr;
  int64_t frame_bytes = 0;
  int64_t n_slots = 0;
  std::vector<uint8_t> storage;
  std::atomic<int64_t> produced{0};
  std::atomic<int64_t> consumed{0};
  std::atomic<bool> done{false};
  std::atomic<bool> stop{false};
  std::thread producer;
  std::mutex mu;
  std::condition_variable cv_can_produce;
  std::condition_variable cv_can_consume;

  void run() {
    while (!stop.load()) {
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_can_produce.wait(lk, [&] {
          return stop.load() ||
                 produced.load() - consumed.load() < n_slots;
        });
      }
      if (stop.load()) break;
      int64_t slot = produced.load() % n_slots;
      size_t got = fread(storage.data() + slot * frame_bytes, 1,
                         (size_t)frame_bytes, file);
      if (got < (size_t)frame_bytes) {
        done.store(true);
        cv_can_consume.notify_all();
        break;
      }
      produced.fetch_add(1);
      cv_can_consume.notify_all();
    }
  }
};

void* s2v_loader_open(const char* path, int64_t frame_bytes, int64_t n_slots) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* rl = new RingLoader();
  rl->file = f;
  rl->frame_bytes = frame_bytes;
  rl->n_slots = n_slots;
  rl->storage.resize((size_t)(frame_bytes * n_slots));
  rl->producer = std::thread([rl] { rl->run(); });
  return rl;
}

// Returns 1 and copies the next frame into `out`; 0 at end of stream.
int s2v_loader_next(void* handle, uint8_t* out) {
  auto* rl = (RingLoader*)handle;
  {
    std::unique_lock<std::mutex> lk(rl->mu);
    rl->cv_can_consume.wait(lk, [&] {
      return rl->produced.load() > rl->consumed.load() || rl->done.load();
    });
  }
  if (rl->produced.load() <= rl->consumed.load()) return 0;
  int64_t slot = rl->consumed.load() % rl->n_slots;
  memcpy(out, rl->storage.data() + slot * rl->frame_bytes,
         (size_t)rl->frame_bytes);
  rl->consumed.fetch_add(1);
  rl->cv_can_produce.notify_all();
  return 1;
}

void s2v_loader_close(void* handle) {
  auto* rl = (RingLoader*)handle;
  rl->stop.store(true);
  rl->cv_can_produce.notify_all();
  if (rl->producer.joinable()) rl->producer.join();
  fclose(rl->file);
  delete rl;
}

}  // extern "C"
