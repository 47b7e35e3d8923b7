// Native audio runtime: WAV codec + interleave/deinterleave + SPSC ring.
//
// The host-side counterpart of the TPU compute path.  Where the reference
// keeps its native code inside a WASM DSP blob (SURVEY.md §2.1), the TPU
// rebuild keeps DSP on the device and uses native code for what the host
// actually does: decoding/encoding PCM containers for the data loader and
// moving samples between the serving loop and audio sinks without the GIL.
//
// Exposed as a plain C ABI consumed via ctypes (bauklank_tpu_torch/runtime/lib.py).
// Build: see bauklank_tpu_torch/runtime/build.py (g++ -O3 -shared -fPIC).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>

extern "C" {

// ---------------------------------------------------------------- WAV codec
// Minimal RIFF/WAVE reader: PCM 16/24/32-bit int and 32-bit float, any
// channel count.  Returns 0 on success.  On success *out_data holds
// deinterleaved float32 planes [channels][frames] in one malloc'd block
// (caller frees via bk_free).

struct WavInfo {
  int32_t channels;
  int32_t sample_rate;
  int64_t frames;
};

static uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
static uint16_t rd_u16(const uint8_t* p) {
  return (uint16_t)(p[0] | (p[1] << 8));
}

int bk_wav_read(const char* path, WavInfo* info, float** out_data) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t hdr[12];
  if (fread(hdr, 1, 12, f) != 12 || memcmp(hdr, "RIFF", 4) ||
      memcmp(hdr + 8, "WAVE", 4)) {
    fclose(f);
    return -2;
  }
  uint16_t fmt = 0, channels = 0, bits = 0;
  uint32_t rate = 0;
  long data_pos = -1;
  uint32_t data_len = 0;
  uint8_t ch[8];
  while (fread(ch, 1, 8, f) == 8) {
    uint32_t len = rd_u32(ch + 4);
    if (!memcmp(ch, "fmt ", 4)) {
      uint8_t buf[40];
      uint32_t n = len < sizeof(buf) ? len : (uint32_t)sizeof(buf);
      if (fread(buf, 1, n, f) != n) { fclose(f); return -3; }
      if (len > n) fseek(f, len - n, SEEK_CUR);
      fmt = rd_u16(buf);
      channels = rd_u16(buf + 2);
      rate = rd_u32(buf + 4);
      bits = rd_u16(buf + 14);
      if (fmt == 0xFFFE && len >= 26) fmt = rd_u16(buf + 24);  // extensible
    } else if (!memcmp(ch, "data", 4)) {
      data_pos = ftell(f);
      data_len = len;
      fseek(f, (len + 1) & ~1u, SEEK_CUR);
    } else {
      fseek(f, (len + 1) & ~1u, SEEK_CUR);
    }
  }
  if (data_pos < 0 || channels == 0 || bits == 0) { fclose(f); return -4; }
  bool is_float = (fmt == 3);
  if (!is_float && fmt != 1) { fclose(f); return -5; }
  int bytes = bits / 8;
  if (bytes < 2 || bytes > 4 || (is_float && bytes != 4)) { fclose(f); return -6; }

  int64_t frames = (int64_t)data_len / (bytes * channels);
  float* out = (float*)malloc(sizeof(float) * (size_t)frames * channels);
  if (!out) { fclose(f); return -7; }
  uint8_t* raw = (uint8_t*)malloc(data_len);
  if (!raw) { free(out); fclose(f); return -7; }
  fseek(f, data_pos, SEEK_SET);
  if (fread(raw, 1, data_len, f) != data_len) {
    free(raw); free(out); fclose(f); return -8;
  }
  fclose(f);

  // deinterleave + convert
  for (int c = 0; c < channels; ++c) {
    float* dst = out + (size_t)c * frames;
    const uint8_t* src = raw + (size_t)c * bytes;
    size_t stride = (size_t)bytes * channels;
    if (is_float) {
      for (int64_t i = 0; i < frames; ++i) {
        float v;
        memcpy(&v, src + i * stride, 4);
        dst[i] = v;
      }
    } else if (bytes == 2) {
      const float k = 1.0f / 32768.0f;
      for (int64_t i = 0; i < frames; ++i) {
        int16_t v = (int16_t)rd_u16(src + i * stride);
        dst[i] = v * k;
      }
    } else if (bytes == 3) {
      const float k = 1.0f / 8388608.0f;
      for (int64_t i = 0; i < frames; ++i) {
        const uint8_t* p = src + i * stride;
        int32_t v = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                              ((uint32_t)p[2] << 16));
        if (v & 0x800000) v |= ~0xFFFFFF;
        dst[i] = v * k;
      }
    } else {  // 4-byte int
      const float k = 1.0f / 2147483648.0f;
      for (int64_t i = 0; i < frames; ++i) {
        int32_t v;
        memcpy(&v, src + i * stride, 4);
        dst[i] = v * k;
      }
    }
  }
  free(raw);
  info->channels = channels;
  info->sample_rate = (int32_t)rate;
  info->frames = frames;
  *out_data = out;
  return 0;
}

// Write PCM16 (fmt 1) or float32 (fmt 3) from deinterleaved planes.
int bk_wav_write(const char* path, const float* planes, int32_t channels,
                 int64_t frames, int32_t sample_rate, int32_t as_float) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  int bytes = as_float ? 4 : 2;
  uint32_t data_len = (uint32_t)(frames * channels * bytes);
  uint8_t hdr[44];
  memcpy(hdr, "RIFF", 4);
  uint32_t riff = 36 + data_len;
  memcpy(hdr + 4, &riff, 4);
  memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmtlen = 16;
  memcpy(hdr + 16, &fmtlen, 4);
  uint16_t fmt = as_float ? 3 : 1;
  memcpy(hdr + 20, &fmt, 2);
  uint16_t ch16 = (uint16_t)channels;
  memcpy(hdr + 22, &ch16, 2);
  memcpy(hdr + 24, &sample_rate, 4);
  uint32_t byterate = (uint32_t)(sample_rate * channels * bytes);
  memcpy(hdr + 28, &byterate, 4);
  uint16_t align = (uint16_t)(channels * bytes);
  memcpy(hdr + 32, &align, 2);
  uint16_t bits = (uint16_t)(bytes * 8);
  memcpy(hdr + 34, &bits, 2);
  memcpy(hdr + 36, "data", 4);
  memcpy(hdr + 40, &data_len, 4);
  fwrite(hdr, 1, 44, f);

  const size_t CHUNK = 65536;
  uint8_t* buf = (uint8_t*)malloc(CHUNK * channels * bytes);
  for (int64_t i = 0; i < frames; i += CHUNK) {
    size_t n = (size_t)((frames - i) < (int64_t)CHUNK ? (frames - i) : CHUNK);
    for (size_t j = 0; j < n; ++j) {
      for (int c = 0; c < channels; ++c) {
        float v = planes[(size_t)c * frames + i + j];
        if (as_float) {
          memcpy(buf + (j * channels + c) * 4, &v, 4);
        } else {
          float s = v * 32767.0f;
          if (s > 32767.0f) s = 32767.0f;
          if (s < -32768.0f) s = -32768.0f;
          int16_t q = (int16_t)(s >= 0 ? s + 0.5f : s - 0.5f);
          memcpy(buf + (j * channels + c) * 2, &q, 2);
        }
      }
    }
    fwrite(buf, 1, n * channels * bytes, f);
  }
  free(buf);
  fclose(f);
  return 0;
}

void bk_free(void* p) { free(p); }

// ------------------------------------------------------- interleave helpers
void bk_interleave(const float* planes, float* out, int32_t channels,
                   int64_t frames) {
  for (int64_t i = 0; i < frames; ++i)
    for (int32_t c = 0; c < channels; ++c)
      out[i * channels + c] = planes[(size_t)c * frames + i];
}

void bk_deinterleave(const float* inter, float* planes, int32_t channels,
                     int64_t frames) {
  for (int64_t i = 0; i < frames; ++i)
    for (int32_t c = 0; c < channels; ++c)
      planes[(size_t)c * frames + i] = inter[i * channels + c];
}

// --------------------------------------------------- lock-free SPSC ring
// Single-producer single-consumer float ring for the serving loop: the
// Python thread pushes rendered chunks, an audio callback thread pops
// fixed-size quanta — the same decoupling the reference gets from the
// browser's render-thread FIFO.

struct BkRing {
  float* data;
  int64_t capacity;  // in floats
  std::atomic<int64_t> head;  // write position (producer)
  std::atomic<int64_t> tail;  // read position (consumer)
};

BkRing* bk_ring_create(int64_t capacity) {
  BkRing* r = new BkRing();
  r->data = (float*)malloc(sizeof(float) * capacity);
  r->capacity = capacity;
  r->head.store(0);
  r->tail.store(0);
  return r;
}

void bk_ring_destroy(BkRing* r) {
  if (!r) return;
  free(r->data);
  delete r;
}

int64_t bk_ring_size(const BkRing* r) {
  return r->head.load(std::memory_order_acquire) -
         r->tail.load(std::memory_order_acquire);
}

int64_t bk_ring_space(const BkRing* r) { return r->capacity - bk_ring_size(r); }

// returns number of floats actually written (may be < n when full)
int64_t bk_ring_push(BkRing* r, const float* src, int64_t n) {
  int64_t head = r->head.load(std::memory_order_relaxed);
  int64_t tail = r->tail.load(std::memory_order_acquire);
  int64_t space = r->capacity - (head - tail);
  if (n > space) n = space;
  for (int64_t i = 0; i < n; ++i)
    r->data[(head + i) % r->capacity] = src[i];
  r->head.store(head + n, std::memory_order_release);
  return n;
}

// returns number of floats popped; missing samples are zero-filled
int64_t bk_ring_pop(BkRing* r, float* dst, int64_t n) {
  int64_t tail = r->tail.load(std::memory_order_relaxed);
  int64_t head = r->head.load(std::memory_order_acquire);
  int64_t avail = head - tail;
  int64_t take = n < avail ? n : avail;
  for (int64_t i = 0; i < take; ++i)
    dst[i] = r->data[(tail + i) % r->capacity];
  for (int64_t i = take; i < n; ++i) dst[i] = 0.0f;
  r->tail.store(tail + take, std::memory_order_release);
  return take;
}

}  // extern "C"
