// FLAC + AIFF decoders for the host data-loading path.
//
// The reference ingests flac/aiff voicebank files through libsndfile
// (ref: SillySampler.py:211-212 globs *.flac/*.aiff/*.mp3 for batch
// extraction; utils/audio_io.py routes them here when soundfile is not
// importable).  This is a dependency-free subset decoder:
//
//   FLAC: native stream decode — STREAMINFO, frame headers (all block
//   size / sample-rate codes), subframe types CONSTANT / VERBATIM /
//   FIXED(0-4) / LPC(1-32), Rice and Rice2 residual partitions with
//   escape codes, wasted bits, and all four channel assignments
//   (independent, left/side, right/side, mid/side), 4-32 bps.
//   CRCs are consumed but not verified (decode integrity is covered by
//   the sample-exact round-trip tests against tests/flac_writer.py).
//
//   AIFF/AIFC: COMM (incl. 80-bit extended sample rate) + SSND, PCM
//   8/16/24/32-bit big-endian; AIFC compression "NONE" and the
//   little-endian "sowt" variant.
//
// Exposed via ctypes (goofer_tpu/native/__init__.py), same float32
// normalization conventions as wavcodec.cpp.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

// ------------------------------------------------------------------ util

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (n < 0) {
    fclose(f);
    return false;
  }
  out->resize((size_t)n);
  bool ok = fread(out->data(), 1, (size_t)n, f) == (size_t)n;
  fclose(f);
  return ok;
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 |
         (uint32_t)p[3];
}

uint16_t be16(const uint8_t* p) { return (uint16_t)(p[0] << 8 | p[1]); }

// ----------------------------------------------------------------- FLAC

struct BitReader {
  const uint8_t* data;
  size_t nbytes;
  size_t bitpos = 0;

  bool eof() const { return bitpos >= nbytes * 8; }

  // Read up to 32 bits, MSB first.  Returns false on EOF.
  bool bits(int n, uint32_t* out) {
    if (bitpos + (size_t)n > nbytes * 8) return false;
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) {
      size_t byte = bitpos >> 3;
      int bit = 7 - (int)(bitpos & 7);
      v = (v << 1) | ((data[byte] >> bit) & 1u);
      ++bitpos;
    }
    *out = v;
    return true;
  }

  bool bits64(int n, uint64_t* out) {
    uint64_t v = 0;
    while (n > 0) {
      int take = n > 24 ? 24 : n;
      uint32_t part;
      if (!bits(take, &part)) return false;
      v = (v << take) | part;
      n -= take;
    }
    *out = v;
    return true;
  }

  // Signed two's-complement of n bits.
  bool sbits(int n, int64_t* out) {
    uint64_t v;
    if (!bits64(n, &v)) return false;
    if (n > 0 && (v >> (n - 1)) & 1u) v |= ~((uint64_t)0) << n;
    *out = (int64_t)v;
    return true;
  }

  // Count zero bits until a set bit (the set bit is consumed).
  bool unary(uint32_t* out) {
    uint32_t q = 0;
    for (;;) {
      uint32_t b;
      if (!bits(1, &b)) return false;
      if (b) break;
      ++q;
      if (q > 1u << 24) return false;  // corrupt stream guard
    }
    *out = q;
    return true;
  }

  void align_byte() { bitpos = (bitpos + 7) & ~(size_t)7; }
};

struct FlacInfo {
  uint32_t sample_rate = 0;
  int channels = 0;
  int bps = 0;
  uint64_t total_samples = 0;
  size_t first_frame_byte = 0;
};

// Parse "fLaC" magic + metadata blocks; leaves offset at first frame.
bool flac_parse_header(const std::vector<uint8_t>& buf, FlacInfo* info) {
  if (buf.size() < 42 || memcmp(buf.data(), "fLaC", 4) != 0) return false;
  size_t off = 4;
  bool have_streaminfo = false;
  for (;;) {
    if (off + 4 > buf.size()) return false;
    uint8_t hdr = buf[off];
    bool last = (hdr & 0x80) != 0;
    int type = hdr & 0x7F;
    uint32_t len = (uint32_t)buf[off + 1] << 16 | (uint32_t)buf[off + 2] << 8 |
                   buf[off + 3];
    off += 4;
    if (off + len > buf.size()) return false;
    if (type == 0 && len >= 34) {  // STREAMINFO
      const uint8_t* p = buf.data() + off;
      info->sample_rate =
          (uint32_t)p[10] << 12 | (uint32_t)p[11] << 4 | (p[12] >> 4);
      info->channels = ((p[12] >> 1) & 0x7) + 1;
      info->bps = (((p[12] & 1) << 4) | (p[13] >> 4)) + 1;
      info->total_samples = ((uint64_t)(p[13] & 0xF) << 32) |
                            (uint64_t)be32(p + 14);
      have_streaminfo = true;
    }
    off += len;
    if (last) break;
  }
  info->first_frame_byte = off;
  return have_streaminfo && info->sample_rate > 0 && info->channels > 0;
}

// Decode one residual-coded sequence into x[order..blocksize).
bool flac_residual(BitReader* br, int order, int blocksize, int64_t* x) {
  uint32_t method, porder;
  if (!br->bits(2, &method) || method > 1) return false;
  if (!br->bits(4, &porder)) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  int nparts = 1 << porder;
  if (blocksize % nparts != 0) return false;
  int idx = order;
  for (int part = 0; part < nparts; ++part) {
    int count = blocksize >> porder;
    if (part == 0) count -= order;
    if (count < 0) return false;
    uint32_t param;
    if (!br->bits(param_bits, &param)) return false;
    if (param == escape) {
      uint32_t raw_bits;
      if (!br->bits(5, &raw_bits)) return false;
      for (int i = 0; i < count; ++i) {
        int64_t v = 0;
        if (raw_bits > 0 && !br->sbits((int)raw_bits, &v)) return false;
        x[idx++] = v;
      }
    } else {
      for (int i = 0; i < count; ++i) {
        uint32_t q;
        uint64_t rem = 0;
        if (!br->unary(&q)) return false;
        if (param > 0 && !br->bits64((int)param, &rem)) return false;
        uint64_t u = ((uint64_t)q << param) | rem;
        x[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
      }
    }
  }
  return true;
}

bool flac_subframe(BitReader* br, int blocksize, int bps,
                   std::vector<int64_t>* out) {
  uint32_t pad, type_code, wflag;
  if (!br->bits(1, &pad) || pad != 0) return false;
  if (!br->bits(6, &type_code)) return false;
  if (!br->bits(1, &wflag)) return false;
  int wasted = 0;
  if (wflag) {
    uint32_t z;
    if (!br->unary(&z)) return false;
    wasted = (int)z + 1;
  }
  int ebps = bps - wasted;
  if (ebps <= 0 || ebps > 33) return false;
  out->assign((size_t)blocksize, 0);
  int64_t* x = out->data();

  if (type_code == 0) {  // CONSTANT
    int64_t v;
    if (!br->sbits(ebps, &v)) return false;
    for (int i = 0; i < blocksize; ++i) x[i] = v;
  } else if (type_code == 1) {  // VERBATIM
    for (int i = 0; i < blocksize; ++i)
      if (!br->sbits(ebps, &x[i])) return false;
  } else if (type_code >= 8 && type_code <= 12) {  // FIXED order 0-4
    int order = (int)type_code - 8;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i)
      if (!br->sbits(ebps, &x[i])) return false;
    if (!flac_residual(br, order, blocksize, x)) return false;
    for (int i = order; i < blocksize; ++i) {
      switch (order) {
        case 0: break;
        case 1: x[i] += x[i - 1]; break;
        case 2: x[i] += 2 * x[i - 1] - x[i - 2]; break;
        case 3: x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3]; break;
        case 4:
          x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4];
          break;
      }
    }
  } else if (type_code >= 32) {  // LPC, order 1-32
    int order = (int)(type_code & 0x1F) + 1;
    if (order > blocksize) return false;
    for (int i = 0; i < order; ++i)
      if (!br->sbits(ebps, &x[i])) return false;
    uint32_t prec_m1;
    if (!br->bits(4, &prec_m1) || prec_m1 == 0xF) return false;
    int precision = (int)prec_m1 + 1;
    int64_t shift;
    if (!br->sbits(5, &shift)) return false;
    if (shift < 0) return false;  // negative shift is spec-reserved
    int64_t coef[32];
    for (int i = 0; i < order; ++i)
      if (!br->sbits(precision, &coef[i])) return false;
    if (!flac_residual(br, order, blocksize, x)) return false;
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * x[i - 1 - j];
      x[i] += acc >> shift;
    }
  } else {
    return false;  // reserved subframe type
  }
  if (wasted > 0)
    for (int i = 0; i < blocksize; ++i) x[i] <<= wasted;
  return true;
}

// Consume the variable-length UTF-8-style frame/sample number.
bool flac_skip_utf8(BitReader* br) {
  uint32_t b0;
  if (!br->bits(8, &b0)) return false;
  int follow = 0;
  for (uint32_t m = 0x80; b0 & m; m >>= 1) ++follow;
  if (follow == 1 || follow > 7) return false;
  if (follow > 0) --follow;  // leading byte counted itself
  for (int i = 0; i < follow; ++i) {
    uint32_t b;
    if (!br->bits(8, &b) || (b & 0xC0) != 0x80) return false;
  }
  return true;
}

// Decode every frame, appending interleaved samples.  max_values bounds
// the output (extra decoded samples are dropped).  *values_written
// reports how many floats were produced — a truncated stream can end
// cleanly at a frame boundary with fewer samples than STREAMINFO
// promised, and the caller must not treat the unwritten tail as audio.
int flac_decode(const std::vector<uint8_t>& buf, const FlacInfo& info,
                float* out, long long max_values,
                long long* values_written) {
  BitReader br{buf.data(), buf.size()};
  br.bitpos = info.first_frame_byte * 8;
  long long written = 0;
  std::vector<int64_t> ch_data[8];
  float scale = 1.0f / (float)(1u << (info.bps - 1));

  while (written < max_values && !br.eof()) {
    uint32_t sync;
    if (!br.bits(14, &sync)) break;
    if (sync != 0x3FFE) return -7;  // lost sync
    uint32_t rsv, strategy, bs_code, sr_code, ch_asgn, ss_code, rsv2;
    if (!br.bits(1, &rsv) || !br.bits(1, &strategy) ||
        !br.bits(4, &bs_code) || !br.bits(4, &sr_code) ||
        !br.bits(4, &ch_asgn) || !br.bits(3, &ss_code) || !br.bits(1, &rsv2))
      return -7;
    if (!flac_skip_utf8(&br)) return -7;
    int blocksize;
    if (bs_code == 1) {
      blocksize = 192;
    } else if (bs_code >= 2 && bs_code <= 5) {
      blocksize = 576 << (bs_code - 2);
    } else if (bs_code == 6) {
      uint32_t v;
      if (!br.bits(8, &v)) return -7;
      blocksize = (int)v + 1;
    } else if (bs_code == 7) {
      uint32_t v;
      if (!br.bits(16, &v)) return -7;
      blocksize = (int)v + 1;
    } else if (bs_code >= 8) {
      blocksize = 256 << (bs_code - 8);
    } else {
      return -7;
    }
    if (sr_code == 12) {
      uint32_t v;
      if (!br.bits(8, &v)) return -7;
    } else if (sr_code == 13 || sr_code == 14) {
      uint32_t v;
      if (!br.bits(16, &v)) return -7;
    } else if (sr_code == 15) {
      return -7;
    }
    uint32_t crc8;
    if (!br.bits(8, &crc8)) return -7;

    int nch = info.channels;
    bool stereo_mode = ch_asgn >= 8 && ch_asgn <= 10;
    if (stereo_mode) nch = 2;
    else if ((int)ch_asgn + 1 != nch) return -7;
    if (nch > 8) return -7;

    for (int c = 0; c < nch; ++c) {
      int bps = info.bps;
      if ((ch_asgn == 8 && c == 1) || (ch_asgn == 9 && c == 0) ||
          (ch_asgn == 10 && c == 1))
        ++bps;  // side channel carries one extra bit
      if (!flac_subframe(&br, blocksize, bps, &ch_data[c])) return -7;
    }
    br.align_byte();
    uint32_t crc16;
    if (!br.bits(16, &crc16)) return -7;

    // stereo decorrelation
    if (ch_asgn == 8) {  // left/side
      for (int i = 0; i < blocksize; ++i)
        ch_data[1][i] = ch_data[0][i] - ch_data[1][i];
    } else if (ch_asgn == 9) {  // right/side: c0=side, c1=right
      for (int i = 0; i < blocksize; ++i) {
        int64_t side = ch_data[0][i];
        ch_data[0][i] = ch_data[1][i] + side;
      }
    } else if (ch_asgn == 10) {  // mid/side
      for (int i = 0; i < blocksize; ++i) {
        int64_t mid = ch_data[0][i], side = ch_data[1][i];
        mid = (mid << 1) | (side & 1);
        ch_data[0][i] = (mid + side) >> 1;
        ch_data[1][i] = (mid - side) >> 1;
      }
    }

    for (int i = 0; i < blocksize && written < max_values; ++i)
      for (int c = 0; c < nch && written < max_values; ++c)
        out[written++] = (float)ch_data[c][i] * scale;
  }
  *values_written = written;
  return written > 0 || max_values == 0 ? 0 : -7;
}

// ----------------------------------------------------------------- AIFF

struct AiffInfo {
  int channels = 0;
  uint32_t frames = 0;
  int bits = 0;
  double sample_rate = 0.0;
  bool little_endian = false;  // AIFC "sowt"
  size_t data_offset = 0;
  size_t data_bytes = 0;
};

double read_extended80(const uint8_t* p) {
  int sign = (p[0] & 0x80) ? -1 : 1;
  int exp = ((p[0] & 0x7F) << 8) | p[1];
  uint64_t mant = 0;
  for (int i = 0; i < 8; ++i) mant = (mant << 8) | p[2 + i];
  if (exp == 0 && mant == 0) return 0.0;
  double v = (double)mant;
  int e = exp - 16383 - 63;
  while (e > 0) { v *= 2.0; --e; }
  while (e < 0) { v *= 0.5; ++e; }
  return sign * v;
}

bool aiff_parse(const std::vector<uint8_t>& buf, AiffInfo* info) {
  if (buf.size() < 12 || memcmp(buf.data(), "FORM", 4) != 0) return false;
  bool aifc = memcmp(buf.data() + 8, "AIFC", 4) == 0;
  if (!aifc && memcmp(buf.data() + 8, "AIFF", 4) != 0) return false;
  size_t off = 12;
  bool have_comm = false, have_ssnd = false;
  while (off + 8 <= buf.size()) {
    const uint8_t* p = buf.data() + off;
    uint32_t len = be32(p + 4);
    size_t body = off + 8;
    if (body + len > buf.size()) len = (uint32_t)(buf.size() - body);
    if (memcmp(p, "COMM", 4) == 0 && len >= 18) {
      const uint8_t* c = buf.data() + body;
      info->channels = (int16_t)be16(c);
      info->frames = be32(c + 2);
      info->bits = (int16_t)be16(c + 6);
      info->sample_rate = read_extended80(c + 8);
      if (aifc && len >= 22) {
        if (memcmp(c + 18, "sowt", 4) == 0) info->little_endian = true;
        else if (memcmp(c + 18, "NONE", 4) != 0) return false;  // compressed
      }
      have_comm = true;
    } else if (memcmp(p, "SSND", 4) == 0 && len >= 8) {
      uint32_t data_off = be32(buf.data() + body);
      if ((size_t)data_off + 8 > len) return false;
      info->data_offset = body + 8 + data_off;
      info->data_bytes = len - 8 - data_off;
      if (info->data_offset > buf.size()) return false;
      if (info->data_offset + info->data_bytes > buf.size())
        info->data_bytes = buf.size() - info->data_offset;
      have_ssnd = true;
    }
    off = body + ((len + 1) & ~1u);
  }
  // Only whole-byte PCM depths are supported (8/16/24/32); rejecting
  // here keeps read_info free of the bits/8 == 0 division (a SIGFPE
  // would kill the host process, not raise).
  bool bits_ok = info->bits == 8 || info->bits == 16 || info->bits == 24 ||
                 info->bits == 32;
  return have_comm && have_ssnd && info->channels > 0 && bits_ok &&
         info->sample_rate > 0;
}

}  // namespace

extern "C" {

int flac_read_info(const char* path, int* sample_rate, int* channels,
                   long long* frames, int* bits) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  FlacInfo info;
  if (!flac_parse_header(buf, &info)) return -2;
  if (info.total_samples == 0) return -6;  // unknown length unsupported
  *sample_rate = (int)info.sample_rate;
  *channels = info.channels;
  *frames = (long long)info.total_samples;
  *bits = info.bps;
  return 0;
}

// Returns the number of float values written (>= 0), or a negative
// error code.  May be less than max_values for a truncated stream.
long long flac_read_f32(const char* path, float* out,
                        long long max_values) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  FlacInfo info;
  if (!flac_parse_header(buf, &info)) return -2;
  long long written = 0;
  int rc = flac_decode(buf, info, out, max_values, &written);
  return rc == 0 ? written : (long long)rc;
}

int aiff_read_info(const char* path, int* sample_rate, int* channels,
                   long long* frames, int* bits) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  AiffInfo info;
  if (!aiff_parse(buf, &info)) return -2;
  *sample_rate = (int)(info.sample_rate + 0.5);
  *channels = info.channels;
  long long by_chunk =
      (long long)(info.data_bytes / ((size_t)(info.bits / 8) * info.channels));
  *frames = info.frames > 0 ? (long long)info.frames : by_chunk;
  if (by_chunk < *frames) *frames = by_chunk;
  *bits = info.bits;
  return 0;
}

// Returns the number of float values written (>= 0), or a negative
// error code (symmetric with flac_read_f32).
long long aiff_read_f32(const char* path, float* out,
                        long long max_values) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  AiffInfo info;
  if (!aiff_parse(buf, &info)) return -2;
  int bytes_per = info.bits / 8;
  if (bytes_per < 1 || bytes_per > 4) return -3;
  long long values = (long long)(info.data_bytes / bytes_per);
  if (values > max_values) values = max_values;
  const uint8_t* p = buf.data() + info.data_offset;

  for (long long i = 0; i < values; ++i) {
    const uint8_t* b = p + i * bytes_per;
    int32_t v = 0;
    if (info.little_endian) {  // AIFC "sowt" (16-bit in practice)
      for (int k = bytes_per - 1; k >= 0; --k) v = (v << 8) | b[k];
    } else {
      for (int k = 0; k < bytes_per; ++k) v = (v << 8) | b[k];
    }
    // sign-extend from bits (AIFF PCM is signed at every depth, incl. 8)
    int shift = 32 - 8 * bytes_per;
    v = (int32_t)((uint32_t)v << shift) >> shift;
    out[i] = (float)((double)v / (double)(1u << (8 * bytes_per - 1)));
  }
  return values;
}

}  // extern "C"
