// RIFF/WAVE codec for the host data-loading path.
//
// The reference loads audio through libsndfile's C engine (soundfile);
// this is the equivalent native component for goofer_tpu: a dependency-free
// chunk-walking WAV reader (PCM 8/16/24/32, IEEE float32/64, extensible
// format) with float32 normalization matching libsndfile conventions, and
// a PCM16 writer (soundfile's default WAV subtype).  Exposed to Python via
// ctypes (see goofer_tpu/native/__init__.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct FmtInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float, 0xFFFE = extensible
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  uint16_t sub_format = 0;   // for extensible
};

struct WavInfo {
  FmtInfo fmt;
  long long data_offset = -1;
  long long data_bytes = 0;
};

bool read_exact(FILE* f, void* dst, size_t n) {
  return fread(dst, 1, n, f) == n;
}

// Walk the RIFF chunks and locate fmt + data.
bool parse_header(FILE* f, WavInfo* info) {
  char tag[4];
  uint32_t riff_size;
  if (!read_exact(f, tag, 4) || memcmp(tag, "RIFF", 4) != 0) return false;
  if (!read_exact(f, &riff_size, 4)) return false;
  if (!read_exact(f, tag, 4) || memcmp(tag, "WAVE", 4) != 0) return false;

  bool have_fmt = false;
  while (read_exact(f, tag, 4)) {
    uint32_t chunk_size;
    if (!read_exact(f, &chunk_size, 4)) return false;
    if (memcmp(tag, "fmt ", 4) == 0) {
      std::vector<uint8_t> buf(chunk_size);
      if (!read_exact(f, buf.data(), chunk_size)) return false;
      if (chunk_size < 16) return false;
      memcpy(&info->fmt.format, buf.data() + 0, 2);
      memcpy(&info->fmt.channels, buf.data() + 2, 2);
      memcpy(&info->fmt.sample_rate, buf.data() + 4, 4);
      memcpy(&info->fmt.bits, buf.data() + 14, 2);
      if (info->fmt.format == 0xFFFE && chunk_size >= 26) {
        memcpy(&info->fmt.sub_format, buf.data() + 24, 2);
      }
      have_fmt = true;
    } else if (memcmp(tag, "data", 4) == 0) {
      info->data_offset = ftell(f);
      info->data_bytes = chunk_size;
      if (fseek(f, (long)((chunk_size + 1) & ~1u), SEEK_CUR) != 0) break;
    } else {
      // skip unknown chunk (word aligned)
      if (fseek(f, (long)((chunk_size + 1) & ~1u), SEEK_CUR) != 0) break;
    }
    if (have_fmt && info->data_offset >= 0) break;
  }
  return have_fmt && info->data_offset >= 0;
}

uint16_t effective_format(const FmtInfo& fmt) {
  return fmt.format == 0xFFFE ? fmt.sub_format : fmt.format;
}

}  // namespace

extern "C" {

// Returns 0 on success, negative error codes otherwise.
int wav_read_info(const char* path, int* sample_rate, int* channels,
                  long long* frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  bool ok = parse_header(f, &info);
  fclose(f);
  if (!ok) return -2;
  uint16_t fmt = effective_format(info.fmt);
  if (fmt != 1 && fmt != 3) return -3;
  if (info.fmt.bits == 0 || info.fmt.channels == 0) return -4;
  *sample_rate = (int)info.fmt.sample_rate;
  *channels = (int)info.fmt.channels;
  *frames = info.data_bytes / ((info.fmt.bits / 8) * info.fmt.channels);
  return 0;
}

// out must hold frames * channels float32 values (interleaved).
int wav_read_f32(const char* path, float* out, long long max_values) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  WavInfo info;
  if (!parse_header(f, &info)) {
    fclose(f);
    return -2;
  }
  uint16_t fmt = effective_format(info.fmt);
  int bytes_per = info.fmt.bits / 8;
  long long values = info.data_bytes / bytes_per;
  if (values > max_values) values = max_values;

  fseek(f, (long)info.data_offset, SEEK_SET);
  std::vector<uint8_t> raw((size_t)(values * bytes_per));
  if (!read_exact(f, raw.data(), raw.size())) {
    fclose(f);
    return -5;
  }
  fclose(f);

  const uint8_t* p = raw.data();
  if (fmt == 3 && info.fmt.bits == 32) {
    memcpy(out, p, (size_t)values * 4);
  } else if (fmt == 3 && info.fmt.bits == 64) {
    for (long long i = 0; i < values; ++i) {
      double v;
      memcpy(&v, p + i * 8, 8);
      out[i] = (float)v;
    }
  } else if (fmt == 1 && info.fmt.bits == 16) {
    for (long long i = 0; i < values; ++i) {
      int16_t v;
      memcpy(&v, p + i * 2, 2);
      out[i] = (float)v / 32768.0f;
    }
  } else if (fmt == 1 && info.fmt.bits == 24) {
    for (long long i = 0; i < values; ++i) {
      const uint8_t* b = p + i * 3;
      int32_t v = (int32_t)((uint32_t)b[0] << 8 | (uint32_t)b[1] << 16 |
                            (uint32_t)b[2] << 24) >> 8;
      out[i] = (float)v / 8388608.0f;
    }
  } else if (fmt == 1 && info.fmt.bits == 32) {
    for (long long i = 0; i < values; ++i) {
      int32_t v;
      memcpy(&v, p + i * 4, 4);
      out[i] = (float)((double)v / 2147483648.0);
    }
  } else if (fmt == 1 && info.fmt.bits == 8) {
    for (long long i = 0; i < values; ++i) {
      out[i] = ((float)p[i] - 128.0f) / 128.0f;
    }
  } else {
    return -3;
  }
  return 0;
}

int wav_write_pcm16(const char* path, const float* data, long long frames,
                    int channels, int sample_rate) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  long long values = frames * channels;
  uint32_t data_bytes = (uint32_t)(values * 2);
  uint32_t riff_size = 36 + data_bytes;
  uint16_t fmt_pcm = 1, ch = (uint16_t)channels, bits = 16;
  uint32_t sr = (uint32_t)sample_rate;
  uint32_t byte_rate = sr * ch * 2;
  uint16_t block_align = ch * 2;
  uint32_t fmt_size = 16;

  fwrite("RIFF", 1, 4, f);
  fwrite(&riff_size, 4, 1, f);
  fwrite("WAVE", 1, 4, f);
  fwrite("fmt ", 1, 4, f);
  fwrite(&fmt_size, 4, 1, f);
  fwrite(&fmt_pcm, 2, 1, f);
  fwrite(&ch, 2, 1, f);
  fwrite(&sr, 4, 1, f);
  fwrite(&byte_rate, 4, 1, f);
  fwrite(&block_align, 2, 1, f);
  fwrite(&bits, 2, 1, f);
  fwrite("data", 1, 4, f);
  fwrite(&data_bytes, 4, 1, f);

  std::vector<int16_t> pcm((size_t)values);
  for (long long i = 0; i < values; ++i) {
    float v = data[i];
    if (v > 32767.0f / 32768.0f) v = 32767.0f / 32768.0f;
    if (v < -1.0f) v = -1.0f;
    float scaled = v * 32768.0f;
    pcm[(size_t)i] = (int16_t)(scaled >= 0 ? scaled + 0.5f : scaled - 0.5f);
  }
  fwrite(pcm.data(), 2, (size_t)values, f);
  fclose(f);
  return 0;
}

}  // extern "C"
