// Native GeoTIFF reader: the real-data input path of the data feed.
//
// SEN12MS-CR / Inria scenes ship as multi-band (up to 13) uint16 GeoTIFFs.
// The reference reads them with rasterio/GDAL (reference
// data_utils/sen12ms_cr_dataLoader.py:118-136, rasterio.open().read()),
// which a training machine often lacks, and PIL cannot decode >4-band
// rasters at all. This file is a dependency-free baseline-TIFF reader
// (zlib aside) covering the EO corpus:
//
//   * classic TIFF, little- or big-endian, first IFD
//   * strip- and tile-organized rasters
//   * chunky (PlanarConfig=1) and planar (=2) layouts
//   * uint8/uint16/uint32/int8/int16/int32/float32/float64 samples
//   * Compression: none (1), LZW (5, MSB-first codes with early change),
//     Deflate (8 and legacy 32946) via zlib
//   * horizontal-differencing predictor (317=2)
//
// Output is always [H, W, S] float32 (exact for <=24-bit integers and
// float32; EO pipelines scale afterwards). The API is two-phase so the
// caller allocates:
//
//   eo_tiff_info(path, info_out[8]) -> 0 | negative error
//       info_out = {width, height, samples, bits, sample_format,
//                   compression, planar, 0}
//   eo_tiff_read(path, out, out_len) -> 0 | negative error
//
// Error codes: -1 open/io, -2 not a TIFF, -3 unsupported feature,
// -4 corrupt structure, -5 bad output buffer, -6 decompression failure.

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct Buf {
  std::vector<uint8_t> d;
  bool big_endian = false;

  uint16_t u16(size_t off) const {
    if (off + 2 > d.size()) return 0;
    return big_endian ? (uint16_t)((d[off] << 8) | d[off + 1])
                      : (uint16_t)(d[off] | (d[off + 1] << 8));
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > d.size()) return 0;
    return big_endian
               ? ((uint32_t)d[off] << 24) | ((uint32_t)d[off + 1] << 16) |
                     ((uint32_t)d[off + 2] << 8) | d[off + 3]
               : (uint32_t)d[off] | ((uint32_t)d[off + 1] << 8) |
                     ((uint32_t)d[off + 2] << 16) | ((uint32_t)d[off + 3] << 24);
  }
};

struct Tag {
  uint16_t id = 0;
  uint16_t type = 0;
  uint32_t count = 0;
  size_t value_off = 0;  // offset of the value field itself (4 bytes inline)
};

constexpr size_t kTypeSize[] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8};

struct Info {
  uint32_t width = 0, height = 0;
  uint32_t samples = 1, bits = 1;
  uint32_t sample_format = 1;  // 1 uint, 2 int, 3 float
  uint32_t compression = 1, planar = 1, predictor = 1;
  uint32_t rows_per_strip = 0xFFFFFFFF;
  uint32_t tile_w = 0, tile_h = 0;
  std::vector<uint64_t> offsets, counts;  // strips or tiles
  bool tiled = false;
};

bool read_file(const char* path, Buf* b) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n <= 0) {
    std::fclose(f);
    return false;
  }
  b->d.resize((size_t)n);
  size_t got = std::fread(b->d.data(), 1, (size_t)n, f);
  std::fclose(f);
  return got == (size_t)n;
}

// Read element i of a tag's value array as an integer.
uint64_t tag_int(const Buf& b, const Tag& t, uint32_t i) {
  size_t esize = t.type < 13 ? kTypeSize[t.type] : 0;
  if (!esize || i >= t.count) return 0;
  size_t total = esize * t.count;
  size_t base = total <= 4 ? t.value_off : b.u32(t.value_off);
  size_t off = base + (size_t)i * esize;
  switch (t.type) {
    case 1:  // BYTE
    case 6:  // SBYTE
    case 7:
      return off < b.d.size() ? b.d[off] : 0;
    case 3:  // SHORT
    case 8:
      return b.u16(off);
    case 4:  // LONG
    case 9:
      return b.u32(off);
    default:
      return 0;
  }
}

int parse(const Buf& b, Info* info) {
  if (b.d.size() < 8) return -2;
  if (b.u16(2) != 42) return -2;  // classic TIFF only (BigTIFF = 43)
  size_t ifd = b.u32(4);
  if (ifd + 2 > b.d.size()) return -4;
  uint16_t n = b.u16(ifd);
  if (ifd + 2 + (size_t)n * 12 > b.d.size()) return -4;

  Tag strip_off, strip_cnt, tile_off, tile_cnt;
  for (uint16_t i = 0; i < n; ++i) {
    Tag t;
    size_t e = ifd + 2 + (size_t)i * 12;
    t.id = b.u16(e);
    t.type = b.u16(e + 2);
    t.count = b.u32(e + 4);
    t.value_off = e + 8;
    switch (t.id) {
      case 256: info->width = (uint32_t)tag_int(b, t, 0); break;
      case 257: info->height = (uint32_t)tag_int(b, t, 0); break;
      case 258: info->bits = (uint32_t)tag_int(b, t, 0); break;
      case 259: info->compression = (uint32_t)tag_int(b, t, 0); break;
      case 273: strip_off = t; break;
      case 277: info->samples = (uint32_t)tag_int(b, t, 0); break;
      case 278: info->rows_per_strip = (uint32_t)tag_int(b, t, 0); break;
      case 279: strip_cnt = t; break;
      case 284: info->planar = (uint32_t)tag_int(b, t, 0); break;
      case 317: info->predictor = (uint32_t)tag_int(b, t, 0); break;
      case 322: info->tile_w = (uint32_t)tag_int(b, t, 0); break;
      case 323: info->tile_h = (uint32_t)tag_int(b, t, 0); break;
      case 324: tile_off = t; break;
      case 325: tile_cnt = t; break;
      case 339: info->sample_format = (uint32_t)tag_int(b, t, 0); break;
      default: break;
    }
  }
  if (!info->width || !info->height) return -4;
  info->tiled = tile_off.count > 0;
  const Tag& off_t = info->tiled ? tile_off : strip_off;
  const Tag& cnt_t = info->tiled ? tile_cnt : strip_cnt;
  if (!off_t.count || off_t.count != cnt_t.count) return -4;
  info->offsets.resize(off_t.count);
  info->counts.resize(off_t.count);
  for (uint32_t i = 0; i < off_t.count; ++i) {
    info->offsets[i] = tag_int(b, off_t, i);
    info->counts[i] = tag_int(b, cnt_t, i);
  }
  if (info->tiled && (!info->tile_w || !info->tile_h)) return -4;
  return 0;
}

int check_supported(const Info& info) {
  if (info.bits != 8 && info.bits != 16 && info.bits != 32 && info.bits != 64)
    return -3;
  if (info.sample_format == 3 && info.bits != 32 && info.bits != 64) return -3;
  if (info.sample_format > 3) return -3;
  if (info.compression != 1 && info.compression != 5 && info.compression != 8 &&
      info.compression != 32946)
    return -3;
  if (info.planar != 1 && info.planar != 2) return -3;
  if (info.predictor != 1 && info.predictor != 2) return -3;
  // undo_predictor only implements the 8/16-bit horizontal difference;
  // accepting wider samples here would return rc=0 with differenced
  // garbage (the silent-corruption path, not the -3 the matrix promises)
  if (info.predictor == 2 && info.bits > 16) return -3;
  // sample_to_float reinterprets 64-bit samples as IEEE double; integer
  // SampleFormat at 64 bits would decode to nonsense, so reject it
  if (info.bits == 64 && info.sample_format != 3) return -3;
  return 0;
}

// ---- decompressors ------------------------------------------------------

int inflate_into(const uint8_t* src, size_t n, std::vector<uint8_t>* out) {
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return -6;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = (uInt)n;
  zs.next_out = out->data();
  zs.avail_out = (uInt)out->size();
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (rc != Z_STREAM_END && rc != Z_OK && rc != Z_BUF_ERROR) return -6;
  return 0;
}

// TIFF LZW: MSB-first variable-width codes, Clear=256, EOI=257, early change
// (code width bumps one code BEFORE the table fills: at 511/1023/2047).
int lzw_into(const uint8_t* src, size_t n, std::vector<uint8_t>* out) {
  struct Entry {
    int16_t prev;    // previous entry (-1 = root)
    uint8_t tail;    // last byte
    uint16_t len;
  };
  std::vector<Entry> table(4096);
  auto reset = [&]() {
    for (int i = 0; i < 256; ++i) table[i] = {(int16_t)-1, (uint8_t)i, 1};
  };
  reset();
  int next_code = 258, width = 9;
  size_t bitpos = 0;
  size_t out_pos = 0;
  int prev_code = -1;
  std::vector<uint8_t> scratch(4096);

  auto emit = [&](int code) -> int {
    int len = table[code].len;
    if (out_pos + len > out->size()) return -6;
    int c = code;
    for (int i = len - 1; i >= 0; --i) {
      scratch[i] = table[c].tail;
      c = table[c].prev;
    }
    std::memcpy(out->data() + out_pos, scratch.data(), len);
    out_pos += len;
    return 0;
  };

  while (bitpos + width <= n * 8) {
    uint32_t code = 0;
    for (int i = 0; i < width; ++i) {
      size_t bp = bitpos + i;
      code = (code << 1) | ((src[bp >> 3] >> (7 - (bp & 7))) & 1);
    }
    bitpos += width;
    if (code == 257) break;  // EOI
    if (code == 256) {       // Clear
      reset();
      next_code = 258;
      width = 9;
      prev_code = -1;
      continue;
    }
    if (prev_code < 0) {
      if (code > 255) return -6;
      if (emit((int)code)) return -6;
      prev_code = (int)code;
      continue;
    }
    if ((int)code < next_code) {
      if (emit((int)code)) return -6;
      // new entry: prev_string + first byte of current string
      int c = (int)code;
      while (table[c].prev >= 0) c = table[c].prev;
      if (next_code < 4096) {
        table[next_code] = {(int16_t)prev_code, table[c].tail,
                            (uint16_t)(table[prev_code].len + 1)};
        ++next_code;
      }
    } else if ((int)code == next_code) {
      // KwKwK case: new entry = prev_string + its own first byte
      int c = prev_code;
      while (table[c].prev >= 0) c = table[c].prev;
      if (next_code < 4096) {
        table[next_code] = {(int16_t)prev_code, table[c].tail,
                            (uint16_t)(table[prev_code].len + 1)};
        ++next_code;
      }
      if (emit((int)code)) return -6;
    } else {
      return -6;
    }
    prev_code = (int)code;
    if (next_code == (1 << width) - 1 && width < 12) ++width;  // early change
  }
  if (out_pos != out->size()) {
    // allow short final segments (some writers omit trailing padding rows)
    std::memset(out->data() + out_pos, 0, out->size() - out_pos);
  }
  return 0;
}

// ---- sample conversion --------------------------------------------------

float sample_to_float(const uint8_t* p, uint32_t bits, uint32_t fmt,
                      bool big_endian) {
  auto rd16 = [&](const uint8_t* q) -> uint16_t {
    return big_endian ? (uint16_t)((q[0] << 8) | q[1])
                      : (uint16_t)(q[0] | (q[1] << 8));
  };
  auto rd32 = [&](const uint8_t* q) -> uint32_t {
    return big_endian ? ((uint32_t)q[0] << 24) | ((uint32_t)q[1] << 16) |
                            ((uint32_t)q[2] << 8) | q[3]
                      : (uint32_t)q[0] | ((uint32_t)q[1] << 8) |
                            ((uint32_t)q[2] << 16) | ((uint32_t)q[3] << 24);
  };
  auto rd64 = [&](const uint8_t* q) -> uint64_t {
    uint64_t hi = rd32(big_endian ? q : q + 4);
    uint64_t lo = rd32(big_endian ? q + 4 : q);
    return (hi << 32) | lo;
  };
  switch (bits) {
    case 8:
      return fmt == 2 ? (float)(int8_t)p[0] : (float)p[0];
    case 16: {
      uint16_t v = rd16(p);
      return fmt == 2 ? (float)(int16_t)v : (float)v;
    }
    case 32: {
      uint32_t v = rd32(p);
      if (fmt == 3) {
        float f;
        std::memcpy(&f, &v, 4);
        return f;
      }
      return fmt == 2 ? (float)(int32_t)v : (float)v;
    }
    case 64: {
      uint64_t v = rd64(p);
      double f;
      std::memcpy(&f, &v, 8);
      return (float)f;
    }
    default:
      return 0.0f;
  }
}

// Undo horizontal differencing in place on raw (still-encoded-endian) rows.
void undo_predictor(uint8_t* data, uint32_t rows, uint32_t cols,
                    uint32_t chans, uint32_t bits, bool big_endian) {
  size_t bytes = bits / 8;
  for (uint32_t r = 0; r < rows; ++r) {
    uint8_t* row = data + (size_t)r * cols * chans * bytes;
    if (bits == 8) {
      for (uint32_t c = 1; c < cols; ++c)
        for (uint32_t k = 0; k < chans; ++k)
          row[c * chans + k] = (uint8_t)(row[c * chans + k] +
                                         row[(c - 1) * chans + k]);
    } else if (bits == 16) {
      for (uint32_t c = 1; c < cols; ++c)
        for (uint32_t k = 0; k < chans; ++k) {
          uint8_t* cur = row + ((size_t)c * chans + k) * 2;
          uint8_t* prv = row + ((size_t)(c - 1) * chans + k) * 2;
          uint16_t a = big_endian ? (uint16_t)((cur[0] << 8) | cur[1])
                                  : (uint16_t)(cur[0] | (cur[1] << 8));
          uint16_t b = big_endian ? (uint16_t)((prv[0] << 8) | prv[1])
                                  : (uint16_t)(prv[0] | (prv[1] << 8));
          uint16_t s = (uint16_t)(a + b);
          if (big_endian) {
            cur[0] = (uint8_t)(s >> 8);
            cur[1] = (uint8_t)s;
          } else {
            cur[0] = (uint8_t)s;
            cur[1] = (uint8_t)(s >> 8);
          }
        }
    }
    // 32-bit predictor-2 is not produced by EO writers; rejected earlier.
  }
}

int decode_segment(const Buf& b, const Info& info, uint32_t seg,
                   std::vector<uint8_t>* raw, size_t expect) {
  if (info.offsets[seg] + info.counts[seg] > b.d.size()) return -4;
  const uint8_t* src = b.d.data() + info.offsets[seg];
  size_t n = info.counts[seg];
  raw->assign(expect, 0);
  switch (info.compression) {
    case 1:
      if (n > expect) n = expect;
      std::memcpy(raw->data(), src, n);
      return 0;
    case 5:
      return lzw_into(src, n, raw);
    case 8:
    case 32946:
      return inflate_into(src, n, raw);
    default:
      return -3;
  }
}

int read_impl(const char* path, float* out, int64_t out_len) {
  Buf b;
  if (!read_file(path, &b)) return -1;
  if (b.d.size() >= 2 && b.d[0] == 'M' && b.d[1] == 'M')
    b.big_endian = true;
  else if (!(b.d.size() >= 2 && b.d[0] == 'I' && b.d[1] == 'I'))
    return -2;
  Info info;
  int rc = parse(b, &info);
  if (rc) return rc;
  rc = check_supported(info);
  if (rc) return rc;

  const uint32_t W = info.width, H = info.height, S = info.samples;
  if (out_len != (int64_t)W * H * S) return -5;
  const size_t bytes = info.bits / 8;
  const uint32_t planes = info.planar == 2 ? S : 1;
  const uint32_t chans = info.planar == 2 ? 1 : S;  // per decoded segment

  std::vector<uint8_t> raw;
  if (!info.tiled) {
    uint32_t rps = info.rows_per_strip ? info.rows_per_strip : H;
    if (rps > H) rps = H;
    uint32_t strips_per_plane = (H + rps - 1) / rps;
    if (info.offsets.size() < (size_t)strips_per_plane * planes) return -4;
    for (uint32_t pl = 0; pl < planes; ++pl) {
      for (uint32_t s = 0; s < strips_per_plane; ++s) {
        uint32_t row0 = s * rps;
        uint32_t rows = row0 + rps <= H ? rps : H - row0;
        size_t expect = (size_t)rows * W * chans * bytes;
        rc = decode_segment(b, info, pl * strips_per_plane + s, &raw, expect);
        if (rc) return rc;
        if (info.predictor == 2)
          undo_predictor(raw.data(), rows, W, chans, info.bits, b.big_endian);
        for (uint32_t r = 0; r < rows; ++r) {
          const uint8_t* src_row = raw.data() + (size_t)r * W * chans * bytes;
          float* dst_row = out + ((size_t)(row0 + r) * W) * S;
          if (info.planar == 1) {
            for (size_t i = 0; i < (size_t)W * S; ++i)
              dst_row[i] = sample_to_float(src_row + i * bytes, info.bits,
                                           info.sample_format, b.big_endian);
          } else {
            for (uint32_t c = 0; c < W; ++c)
              dst_row[(size_t)c * S + pl] =
                  sample_to_float(src_row + (size_t)c * bytes, info.bits,
                                  info.sample_format, b.big_endian);
          }
        }
      }
    }
  } else {
    uint32_t tw = info.tile_w, th = info.tile_h;
    uint32_t tx = (W + tw - 1) / tw, ty = (H + th - 1) / th;
    if (info.offsets.size() < (size_t)tx * ty * planes) return -4;
    for (uint32_t pl = 0; pl < planes; ++pl) {
      for (uint32_t t = 0; t < tx * ty; ++t) {
        uint32_t row0 = (t / tx) * th, col0 = (t % tx) * tw;
        size_t expect = (size_t)tw * th * chans * bytes;
        rc = decode_segment(b, info, pl * tx * ty + t, &raw, expect);
        if (rc) return rc;
        if (info.predictor == 2)
          undo_predictor(raw.data(), th, tw, chans, info.bits, b.big_endian);
        uint32_t rows = row0 + th <= H ? th : H - row0;
        uint32_t cols = col0 + tw <= W ? tw : W - col0;
        for (uint32_t r = 0; r < rows; ++r) {
          const uint8_t* src_row = raw.data() + (size_t)r * tw * chans * bytes;
          float* dst_row = out + ((size_t)(row0 + r) * W + col0) * S;
          if (info.planar == 1) {
            for (uint32_t c = 0; c < cols; ++c)
              for (uint32_t k = 0; k < S; ++k)
                dst_row[(size_t)c * S + k] = sample_to_float(
                    src_row + ((size_t)c * S + k) * bytes, info.bits,
                    info.sample_format, b.big_endian);
          } else {
            for (uint32_t c = 0; c < cols; ++c)
              dst_row[(size_t)c * S + pl] =
                  sample_to_float(src_row + (size_t)c * bytes, info.bits,
                                  info.sample_format, b.big_endian);
          }
        }
      }
    }
  }
  return 0;
}

}  // namespace

extern "C" {

int eo_tiff_info(const char* path, int64_t* info_out) {
  Buf b;
  if (!read_file(path, &b)) return -1;
  if (b.d.size() >= 2 && b.d[0] == 'M' && b.d[1] == 'M')
    b.big_endian = true;
  else if (!(b.d.size() >= 2 && b.d[0] == 'I' && b.d[1] == 'I'))
    return -2;
  Info info;
  int rc = parse(b, &info);
  if (rc) return rc;
  rc = check_supported(info);
  if (rc) return rc;
  info_out[0] = info.width;
  info_out[1] = info.height;
  info_out[2] = info.samples;
  info_out[3] = info.bits;
  info_out[4] = info.sample_format;
  info_out[5] = info.compression;
  info_out[6] = info.planar;
  info_out[7] = 0;
  return 0;
}

int eo_tiff_read(const char* path, float* out, int64_t out_len) {
  return read_impl(path, out, out_len);
}

}  // extern "C"
