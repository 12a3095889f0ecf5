// High-throughput IQ stream reader / converter (host data plane).
//
// (reference capability: the GNU Radio file_source + int8->complex
// conversion blocks feeding LTE_fdd_dl_file_scan, and the enodeb radio
// buffer loop — the host-native IO layer of the framework.  SURVEY.md §2.6
// C2/C8: the framework's host side must feed >=30.72 Msps x N carriers
// without starving the devices; this module is the native producer: pread-based
// chunk reads, SIMD-friendly int8->float conversion, and a double-buffered
// background-prefetch stream so conversion overlaps device compute.)
//
// Build: make -C lteax/native   (g++ -O3 -march=native -shared -fPIC)
// Python binding: lteax/io/native.py via ctypes.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <condition_variable>
#include <mutex>
#include <thread>

extern "C" {

// ---------------------------------------------------------------------------
// Conversions (auto-vectorized; restrict + simple loops)
// ---------------------------------------------------------------------------

void iq_sc8_to_f32(const int8_t* __restrict in, float* __restrict out,
                   int64_t n_values) {
  const float s = 1.0f / 128.0f;
  for (int64_t i = 0; i < n_values; ++i) out[i] = (float)in[i] * s;
}

void iq_sc16_to_f32(const int16_t* __restrict in, float* __restrict out,
                    int64_t n_values) {
  const float s = 1.0f / 32768.0f;
  for (int64_t i = 0; i < n_values; ++i) out[i] = (float)in[i] * s;
}

void iq_f32_to_sc8(const float* __restrict in, int8_t* __restrict out,
                   int64_t n_values) {
  for (int64_t i = 0; i < n_values; ++i) {
    float v = in[i] * 127.0f;
    if (v > 127.0f) v = 127.0f;
    if (v < -128.0f) v = -128.0f;
    out[i] = (int8_t)(v >= 0 ? v + 0.5f : v - 0.5f);
  }
}

// One-shot read + convert: returns complex sample count written (I/Q pairs).
// fmt: 0 = fc32 (passthrough), 1 = sc8, 2 = sc16.
int64_t iq_read(const char* path, int fmt, int64_t offset_samples,
                int64_t count_samples, float* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int itemsize = fmt == 0 ? 8 : (fmt == 1 ? 2 : 4);
  if (fseek(f, offset_samples * (long)itemsize, SEEK_SET) != 0) {
    fclose(f);
    return -1;
  }
  int64_t n = 0;
  const int64_t CHUNK = 1 << 20;  // samples per chunk
  void* buf = malloc((size_t)CHUNK * itemsize);
  while (count_samples < 0 || n < count_samples) {
    int64_t want = CHUNK;
    if (count_samples >= 0 && count_samples - n < want)
      want = count_samples - n;
    size_t got = fread(buf, itemsize, (size_t)want, f);
    if (got == 0) break;
    if (fmt == 0) {
      memcpy(out + 2 * n, buf, got * itemsize);
    } else if (fmt == 1) {
      iq_sc8_to_f32((const int8_t*)buf, out + 2 * n, (int64_t)got * 2);
    } else {
      iq_sc16_to_f32((const int16_t*)buf, out + 2 * n, (int64_t)got * 2);
    }
    n += (int64_t)got;
    if (got < (size_t)want) break;
  }
  free(buf);
  fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// Double-buffered background-prefetch stream
// ---------------------------------------------------------------------------

struct IqStream {
  FILE* f = nullptr;
  int fmt = 0;
  int64_t chunk = 0;  // complex samples per chunk
  float* bufs[2] = {nullptr, nullptr};
  int64_t filled[2] = {0, 0};
  int ready_slot = -1;       // slot holding a chunk ready for the consumer
  bool eof = false;
  bool stop = false;
  std::thread th;
  std::mutex mu;
  std::condition_variable cv_prod, cv_cons;
  void* raw = nullptr;
};

static void stream_worker(IqStream* s) {
  int slot = 0;
  int itemsize = s->fmt == 0 ? 8 : (s->fmt == 1 ? 2 : 4);
  for (;;) {
    size_t got = fread(s->raw, itemsize, (size_t)s->chunk, s->f);
    float* dst = s->bufs[slot];
    if (s->fmt == 0)
      memcpy(dst, s->raw, got * itemsize);
    else if (s->fmt == 1)
      iq_sc8_to_f32((const int8_t*)s->raw, dst, (int64_t)got * 2);
    else
      iq_sc16_to_f32((const int16_t*)s->raw, dst, (int64_t)got * 2);
    std::unique_lock<std::mutex> lk(s->mu);
    s->cv_prod.wait(lk, [&] { return s->ready_slot == -1 || s->stop; });
    if (s->stop) return;
    s->filled[slot] = (int64_t)got;
    s->ready_slot = slot;
    if (got < (size_t)s->chunk) s->eof = true;
    s->cv_cons.notify_one();
    if (s->eof) return;
    slot ^= 1;
  }
}

void* iq_stream_open(const char* path, int fmt, int64_t chunk_samples) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  IqStream* s = new IqStream();
  s->f = f;
  s->fmt = fmt;
  s->chunk = chunk_samples;
  int itemsize = fmt == 0 ? 8 : (fmt == 1 ? 2 : 4);
  s->bufs[0] = (float*)malloc((size_t)chunk_samples * 8);
  s->bufs[1] = (float*)malloc((size_t)chunk_samples * 8);
  s->raw = malloc((size_t)chunk_samples * itemsize);
  s->th = std::thread(stream_worker, s);
  return s;
}

// Copies the next chunk into out; returns complex samples (0 at EOF).
int64_t iq_stream_next(void* handle, float* out) {
  IqStream* s = (IqStream*)handle;
  std::unique_lock<std::mutex> lk(s->mu);
  s->cv_cons.wait(lk, [&] { return s->ready_slot != -1 ||
                                   (s->eof && s->ready_slot == -1); });
  if (s->ready_slot == -1) return 0;
  int slot = s->ready_slot;
  int64_t n = s->filled[slot];
  memcpy(out, s->bufs[slot], (size_t)n * 8);
  s->ready_slot = -1;
  s->cv_prod.notify_one();
  return n;
}

void iq_stream_close(void* handle) {
  IqStream* s = (IqStream*)handle;
  {
    std::unique_lock<std::mutex> lk(s->mu);
    s->stop = true;
    s->ready_slot = -1;
    s->cv_prod.notify_all();
  }
  if (s->th.joinable()) s->th.join();
  fclose(s->f);
  free(s->bufs[0]);
  free(s->bufs[1]);
  free(s->raw);
  delete s;
}

}  // extern "C"
