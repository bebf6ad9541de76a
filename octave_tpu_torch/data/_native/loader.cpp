// octave_tpu_torch native image loader: decode to 8-bit grey and threaded
// batch assembly, behind a plain C ABI used through ctypes.
//
// The port's own copy of octave_tpu/data/_native/loader.cpp, with three
// changes:
//   * PNG is decoded with zlib alone (inflate, then the five row filters), so
//     the loader needs no libpng; colour PNG becomes grey by the ITU-R 601
//     integer luma (299 R + 587 G + 114 B) / 1000, as BMP does. Every format
//     therefore reads byte for byte as utils/imageio.py::read_image reads it.
//   * TIFF: the first page of a little- or big-endian file; strips,
//     PlanarConfiguration 1, 8 bits per sample, grey (Photometric 1) or RGB
//     (2, with an optional extra sample such as alpha, dropped), no
//     compression, LZW, Deflate or PackBits, Predictor 1 or 2 (applied to
//     LZW and Deflate strips, as libtiff does).
//   * A failure returns its reason through the ABI (a caller-owned buffer).
// Kept from the original: BMP and binary PGM, the exception firewall, the
// thread pool and the nearest resize src = floor(dst * in / out).
//
// Every header field is untrusted: dimensions are capped and every offset
// and byte count is checked against the file's size in 64-bit arithmetic
// before anything is allocated from it.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <mutex>
#include <string>
#include <system_error>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> gray;  // row-major h*w, 8-bit grey
  int w = 0, h = 0;
  std::string err;  // empty on success
};

struct DecodeError {
  std::string what;
};

[[noreturn]] void fail(const std::string& what) { throw DecodeError{what}; }

constexpr int64_t kMaxDim = 1 << 16;              // pixels per side
constexpr int64_t kMaxPixels = int64_t(1) << 28;  // 256 MPix
constexpr uint64_t kDeflateMaxRatio = 1032;        // 258 bytes per 2-bit code

void check_dims(int64_t w, int64_t h, const char* what) {
  if (!(w > 0 && h > 0 && w <= kMaxDim && h <= kMaxDim && w * h <= kMaxPixels))
    fail(std::string(what) + " dimensions out of range: " + std::to_string(w) + "x" +
         std::to_string(h));
}

uint8_t luma601(uint32_t r, uint32_t g, uint32_t b) {
  return static_cast<uint8_t>((299 * r + 587 * g + 114 * b) / 1000);
}

std::vector<uint8_t> read_file(const char* path) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) fail("open failed");
  std::vector<uint8_t> buf;
  if (std::fseek(fp, 0, SEEK_END) == 0) {
    const long size = std::ftell(fp);
    if (size >= 0 && std::fseek(fp, 0, SEEK_SET) == 0) {
      buf.resize(static_cast<size_t>(size));
      const size_t got = size ? std::fread(buf.data(), 1, buf.size(), fp) : 0;
      std::fclose(fp);
      if (got != buf.size()) fail("read failed");
      return buf;
    }
  }
  std::fclose(fp);
  fail("cannot size the file");
}

uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}
uint32_t le32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}
uint16_t le16(const uint8_t* p) { return static_cast<uint16_t>(p[0] | (p[1] << 8)); }

// Inflate a zlib stream into dst[0, cap). Returns the bytes written and
// whether the stream ended; a corrupt stream fails.
size_t inflate_into(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, bool* ended,
                    const char* what) {
  if (n > 0xFFFFFFF0u || cap > 0xFFFFFFF0u) fail(std::string(what) + ": data too large");
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) fail("zlib init failed");
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = static_cast<uInt>(n);
  zs.next_out = dst;
  zs.avail_out = static_cast<uInt>(cap);
  int rc;
  do {
    rc = inflate(&zs, Z_FINISH);
  } while (rc == Z_OK);
  const size_t produced = cap - zs.avail_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END && rc != Z_BUF_ERROR)
    fail(std::string(what) + ": corrupt compressed data");
  *ended = rc == Z_STREAM_END;
  return produced;
}

// ---------------------------------------------------------------- PNG ----
const uint8_t kPngSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

int png_channels(int color) {
  switch (color) {
    case 0: return 1;
    case 2: return 3;
    case 3: return 1;
    case 4: return 2;
    case 6: return 4;
    default: return 0;
  }
}

bool png_depth_ok(int color, int depth) {
  switch (color) {
    case 0: return depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16;
    case 3: return depth == 1 || depth == 2 || depth == 4 || depth == 8;
    case 2: case 4: case 6: return depth == 8 || depth == 16;
    default: return false;
  }
}

void png_unfilter(uint8_t* data, int h, size_t rowbytes, size_t bpp) {
  // data: h rows of (filter byte, rowbytes bytes), undone in place; the
  // row above the first is zeros
  std::vector<uint8_t> zeros(rowbytes, 0);
  const uint8_t* up = zeros.data();
  for (int y = 0; y < h; ++y) {
    uint8_t* line = data + static_cast<size_t>(y) * (rowbytes + 1);
    const int ftype = line[0];
    uint8_t* cur = line + 1;
    const size_t lead = bpp < rowbytes ? bpp : rowbytes;  // bytes with no left pixel
    switch (ftype) {
      case 0: break;
      case 1:
        for (size_t i = bpp; i < rowbytes; ++i) cur[i] = static_cast<uint8_t>(cur[i] + cur[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; ++i) cur[i] = static_cast<uint8_t>(cur[i] + up[i]);
        break;
      case 3:
        for (size_t i = 0; i < lead; ++i) cur[i] = static_cast<uint8_t>(cur[i] + (up[i] >> 1));
        for (size_t i = bpp; i < rowbytes; ++i)
          cur[i] = static_cast<uint8_t>(cur[i] + ((cur[i - bpp] + up[i]) >> 1));
        break;
      case 4:
        for (size_t i = 0; i < lead; ++i) cur[i] = static_cast<uint8_t>(cur[i] + up[i]);
        for (size_t i = bpp; i < rowbytes; ++i) {
          const int a = cur[i - bpp], b = up[i], c = up[i - bpp];
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          cur[i] = static_cast<uint8_t>(cur[i] + ((pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c)));
        }
        break;
      default: fail("png: unknown row filter " + std::to_string(ftype));
    }
    up = cur;
  }
}

Image decode_png(const std::vector<uint8_t>& buf) {
  const size_t size = buf.size();
  size_t pos = 8;
  const uint8_t* ihdr = nullptr;
  uint32_t ihdr_len = 0;
  const uint8_t* palette = nullptr;
  uint32_t palette_len = 0;
  std::vector<uint8_t> idat;
  while (pos + 8 <= size) {
    const uint64_t length = be32(&buf[pos]);
    const uint8_t* tag = &buf[pos + 4];
    if (pos + 8 + length > size) fail("png truncated inside a chunk");
    const uint8_t* body = &buf[pos + 8];
    pos += 12 + length;  // length, tag, body, crc
    if (!std::memcmp(tag, "IHDR", 4)) {
      ihdr = body;
      ihdr_len = static_cast<uint32_t>(length);
    } else if (!std::memcmp(tag, "PLTE", 4)) {
      if (length % 3) fail("png: palette length is not a multiple of 3");
      palette = body;
      palette_len = static_cast<uint32_t>(length / 3);
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + length);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
  }
  if (!ihdr || ihdr_len != 13 || idat.empty()) fail("png without IHDR or IDAT");
  const int64_t w = be32(ihdr), h = be32(ihdr + 4);
  const int depth = ihdr[8], color = ihdr[9], interlace = ihdr[12];
  check_dims(w, h, "png");
  if (!png_channels(color) || !png_depth_ok(color, depth))
    fail("png: unsupported colour type " + std::to_string(color) + " at " +
         std::to_string(depth) + " bits");
  if (interlace) fail("png: interlaced files are not supported");
  const int channels = png_channels(color);
  const size_t bits = static_cast<size_t>(channels) * depth;
  const size_t rowbytes = (static_cast<size_t>(w) * bits + 7) / 8;
  const size_t bpp = bits >= 8 ? bits / 8 : 1;
  // one byte of room more than the rows need, so a too-long stream shows
  const size_t expected = static_cast<size_t>(h) * (rowbytes + 1);
  // Deflate expands at most 1032-fold: a header that asks for more than the
  // IDAT bytes can hold is refused before the rows are allocated
  if (expected / kDeflateMaxRatio > idat.size())
    fail("png: " + std::to_string(idat.size()) + " bytes of IDAT cannot hold " +
         std::to_string(w) + "x" + std::to_string(h) + " pixels");
  std::vector<uint8_t> data(expected + 1);
  bool ended = false;
  if (inflate_into(idat.data(), idat.size(), data.data(), data.size(), &ended, "png") !=
          expected || !ended)
    fail("png: pixel data has the wrong length");
  png_unfilter(data.data(), static_cast<int>(h), rowbytes, bpp);

  Image out;
  out.w = static_cast<int>(w);
  out.h = static_cast<int>(h);
  out.gray.resize(static_cast<size_t>(w) * h);
  const int bytes_per_sample = depth == 16 ? 2 : 1;
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = &data[static_cast<size_t>(y) * (rowbytes + 1) + 1];
    uint8_t* dst = &out.gray[static_cast<size_t>(y) * w];
    if (depth < 8) {
      const int per_byte = 8 / depth, mask = (1 << depth) - 1;
      const int scale = color == 0 ? 255 / mask : 1;
      for (int64_t x = 0; x < w; ++x) {
        const int shift = 8 - depth * (static_cast<int>(x % per_byte) + 1);
        const int v = (row[x / per_byte] >> shift) & mask;
        if (color == 3) {
          if (!palette || v >= static_cast<int>(palette_len))
            fail("png: palette missing or too short");
          const uint8_t* rgb = palette + 3 * v;
          dst[x] = luma601(rgb[0], rgb[1], rgb[2]);
        } else {
          dst[x] = static_cast<uint8_t>(v * scale);
        }
      }
      continue;
    }
    // 8 or 16 bits: the high byte of each sample comes first
    const size_t px = static_cast<size_t>(channels) * bytes_per_sample;
    for (int64_t x = 0; x < w; ++x) {
      const uint8_t* s = row + x * px;
      if (color == 3) {
        if (!palette || s[0] >= palette_len) fail("png: palette missing or too short");
        const uint8_t* rgb = palette + 3 * s[0];
        dst[x] = luma601(rgb[0], rgb[1], rgb[2]);
      } else if (color == 2 || color == 6) {
        dst[x] = luma601(s[0], s[bytes_per_sample], s[2 * bytes_per_sample]);
      } else {
        dst[x] = s[0];
      }
    }
  }
  return out;
}

// ---------------------------------------------------------------- BMP ----
Image decode_bmp(const std::vector<uint8_t>& buf) {
  const uint64_t fsize = buf.size();
  if (fsize < 54) fail("bmp read failed");
  const uint32_t data_off = le32(&buf[10]);
  const uint32_t hdr_size = le32(&buf[14]);
  const int32_t w = static_cast<int32_t>(le32(&buf[18]));
  int32_t h = static_cast<int32_t>(le32(&buf[22]));
  const uint16_t bpp = le16(&buf[28]);
  const uint32_t comp = le32(&buf[30]);
  const bool topdown = h < 0;
  if (topdown) h = -h;
  if (comp != 0 || (bpp != 8 && bpp != 24 && bpp != 32) || hdr_size < 40)
    fail("unsupported bmp variant");
  check_dims(w, h, "bmp");
  const uint64_t row_stride = ((static_cast<uint64_t>(w) * bpp + 31) / 32) * 4;
  if (static_cast<uint64_t>(data_off) > fsize ||
      static_cast<uint64_t>(data_off) + row_stride * h > fsize)
    fail("bmp truncated");
  // an 8-bit row may hold any of 256 indices, so the whole palette must fit
  if (bpp == 8 && 14ull + hdr_size + 256ull * 4 > fsize) fail("bmp palette truncated");
  Image out;
  out.w = w;
  out.h = h;
  out.gray.resize(static_cast<size_t>(w) * h);
  const uint8_t* palette = (bpp == 8) ? &buf[14 + hdr_size] : nullptr;
  for (int32_t y = 0; y < h; ++y) {
    const int32_t src_y = topdown ? y : (h - 1 - y);
    const uint8_t* row = &buf[data_off + row_stride * src_y];
    uint8_t* dst = &out.gray[static_cast<size_t>(y) * w];
    if (bpp == 8) {
      for (int32_t x = 0; x < w; ++x) dst[x] = palette[row[x] * 4];
    } else {
      const int step = bpp / 8;
      for (int32_t x = 0; x < w; ++x) {
        const uint8_t* px = row + x * step;  // BGR
        dst[x] = luma601(px[2], px[1], px[0]);
      }
    }
  }
  return out;
}

// ---------------------------------------------------------------- PGM ----
Image decode_pgm(const std::vector<uint8_t>& buf) {
  // "P5" <ws>* w <ws>+ h <ws>+ maxval, then one whitespace byte
  size_t pos = 2;
  const size_t n = buf.size();
  auto space = [&](size_t i) {
    return i < n && (buf[i] == ' ' || buf[i] == '\t' || buf[i] == '\n' || buf[i] == '\r' ||
                     buf[i] == '\v' || buf[i] == '\f');
  };
  int64_t vals[3];
  for (int k = 0; k < 3; ++k) {
    const size_t start = pos;
    while (space(pos)) ++pos;
    if (k > 0 && pos == start) fail("unsupported pgm");
    bool neg = false;
    if (pos < n && buf[pos] == '-') {
      neg = true;
      ++pos;
    }
    int64_t v = 0;
    size_t digits = 0;
    while (pos < n && buf[pos] >= '0' && buf[pos] <= '9') {
      if (v < (int64_t(1) << 40)) v = v * 10 + (buf[pos] - '0');
      ++pos;
      ++digits;
    }
    if (!digits) fail("unsupported pgm");
    vals[k] = neg ? -v : v;
  }
  const int64_t w = vals[0], h = vals[1], maxv = vals[2];
  if (maxv > 255 || maxv < 1) fail("unsupported pgm");
  check_dims(w, h, "pgm");
  const uint64_t start = pos + 1;  // one whitespace byte after maxval
  if (n < start + static_cast<uint64_t>(w * h)) fail("pgm truncated");
  Image out;
  out.w = static_cast<int>(w);
  out.h = static_cast<int>(h);
  out.gray.assign(buf.begin() + start, buf.begin() + start + w * h);
  return out;
}

// --------------------------------------------------------------- TIFF ----
struct Tiff {
  const std::vector<uint8_t>& buf;
  bool big;  // "MM": big-endian

  uint16_t u16(uint64_t off) const {
    if (off + 2 > buf.size()) fail("tiff truncated");
    const uint8_t* p = &buf[off];
    return big ? static_cast<uint16_t>((p[0] << 8) | p[1]) : le16(p);
  }
  uint32_t u32(uint64_t off) const {
    if (off + 4 > buf.size()) fail("tiff truncated");
    const uint8_t* p = &buf[off];
    return big ? be32(p) : le32(p);
  }

  // The values of one IFD entry of integer type (BYTE, SHORT or LONG).
  std::vector<uint64_t> values(uint64_t entry, uint16_t tag) const {
    const uint16_t type = u16(entry + 2);
    const uint64_t count = u32(entry + 4);
    const int size = type == 1 ? 1 : type == 3 ? 2 : type == 4 ? 4 : 0;
    if (!size) fail("tiff: tag " + std::to_string(tag) + " has field type " +
                    std::to_string(type) + ", not an unsigned integer");
    if (count == 0) fail("tiff: tag " + std::to_string(tag) + " has no value");
    const uint64_t nbytes = count * size;
    const uint64_t at = nbytes <= 4 ? entry + 8 : u32(entry + 8);
    if (at > buf.size() || nbytes > buf.size() - at)
      fail("tiff: tag " + std::to_string(tag) + " points past the end of the file");
    std::vector<uint64_t> out(count);
    for (uint64_t i = 0; i < count; ++i)
      out[i] = size == 1 ? buf[at + i] : size == 2 ? u16(at + 2 * i) : u32(at + 4 * i);
    return out;
  }
};

// TIFF LZW (MSB-first codes of 9 to 12 bits, Clear 256, EOI 257, the code
// width growing one code early). Writes at most `cap` bytes; returns the
// number written.
size_t tiff_lzw(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  constexpr int kClear = 256, kEoi = 257, kMaxCodes = 4096;
  std::vector<uint16_t> prefix(kMaxCodes);
  std::vector<uint8_t> suffix(kMaxCodes), first(kMaxCodes);
  std::vector<uint32_t> length(kMaxCodes);
  for (int i = 0; i < 256; ++i) {
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int next = 258, nbits = 9, prev = -1;
  uint64_t bitpos = 0;
  const uint64_t total_bits = static_cast<uint64_t>(n) * 8;
  size_t out = 0;
  auto emit = [&](int code) {  // write the string of `code`, capped at `cap`
    const uint32_t len = length[code];
    const size_t room = cap - out;
    int c = code;
    for (uint32_t k = len; k-- > 0;) {
      if (k < room) dst[out + k] = suffix[c];
      c = prefix[c];
    }
    out += len < room ? len : room;
  };
  while (out < cap && bitpos + nbits <= total_bits) {
    int code = 0;
    for (int b = 0; b < nbits; ++b, ++bitpos)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == kEoi) break;
    if (code == kClear) {
      next = 258;
      nbits = 9;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255) fail("tiff: corrupt LZW data (no literal after a clear)");
      emit(code);
      prev = code;
      continue;
    }
    uint8_t head;
    if (code < next) {
      head = first[code];
    } else if (code == next) {
      head = first[prev];
    } else {
      fail("tiff: corrupt LZW data (code past the table)");
    }
    if (next < kMaxCodes) {
      prefix[next] = static_cast<uint16_t>(prev);
      suffix[next] = head;
      first[next] = first[prev];
      length[next] = length[prev] + 1;
      ++next;
      if (next + 1 >= (1 << nbits) && nbits < 12) ++nbits;
    }
    emit(code);
    prev = code;
  }
  return out;
}

size_t tiff_packbits(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  size_t i = 0, out = 0;
  while (i < n && out < cap) {
    const int c = static_cast<int8_t>(src[i++]);
    if (c >= 0) {
      const size_t run = static_cast<size_t>(c) + 1;
      if (i + run > n) fail("tiff: PackBits literal runs past the strip");
      const size_t take = run < cap - out ? run : cap - out;
      std::memcpy(dst + out, src + i, take);
      i += run;
      out += take;
    } else if (c != -128) {
      if (i >= n) fail("tiff: PackBits run past the strip");
      const size_t run = static_cast<size_t>(1 - c);
      const size_t take = run < cap - out ? run : cap - out;
      std::memset(dst + out, src[i++], take);
      out += take;
    }
  }
  return out;
}

Image decode_tiff(const std::vector<uint8_t>& buf) {
  if (buf.size() < 8) fail("tiff truncated");
  const Tiff t{buf, buf[0] == 'M'};
  const uint64_t ifd = t.u32(4);
  const uint64_t n_entries = t.u16(ifd);
  if (ifd + 2 + 12 * n_entries > buf.size()) fail("tiff: directory runs past the end of the file");
  uint64_t width = 0, height = 0, compression = 1, photometric = 99, spp = 1;
  uint64_t rows_per_strip = 0xFFFFFFFFull, planar = 1, predictor = 1, fill_order = 1,
           sample_format = 1;
  std::vector<uint64_t> bits, offsets, counts, extra;
  bool tiled = false;
  for (uint64_t i = 0; i < n_entries; ++i) {
    const uint64_t e = ifd + 2 + 12 * i;
    const uint16_t tag = t.u16(e);
    switch (tag) {
      case 256: width = t.values(e, tag)[0]; break;
      case 257: height = t.values(e, tag)[0]; break;
      case 258: bits = t.values(e, tag); break;
      case 259: compression = t.values(e, tag)[0]; break;
      case 262: photometric = t.values(e, tag)[0]; break;
      case 266: fill_order = t.values(e, tag)[0]; break;
      case 273: offsets = t.values(e, tag); break;
      case 277: spp = t.values(e, tag)[0]; break;
      case 278: rows_per_strip = t.values(e, tag)[0]; break;
      case 279: counts = t.values(e, tag); break;
      case 284: planar = t.values(e, tag)[0]; break;
      case 317: predictor = t.values(e, tag)[0]; break;
      case 338: extra = t.values(e, tag); break;
      case 339: sample_format = t.values(e, tag)[0]; break;
      case 322: case 323: case 324: case 325: tiled = true; break;
      default: break;
    }
  }
  if (tiled) fail("tiff: tiled images are not supported (strips only)");
  check_dims(static_cast<int64_t>(width), static_cast<int64_t>(height), "tiff");
  if (bits.empty()) fail("tiff: 1-bit images are not supported (8 bits per sample only)");
  for (uint64_t b : bits)
    if (b != 8)
      fail("tiff: " + std::to_string(b) + "-bit samples are not supported (8 bits only)");
  if (sample_format != 1) fail("tiff: only unsigned integer samples are supported");
  if (fill_order != 1) fail("tiff: FillOrder 2 is not supported");
  if (planar != 1) fail("tiff: PlanarConfiguration 2 is not supported");
  if (photometric == 0) fail("tiff: WhiteIsZero is not supported");
  if (photometric == 3) fail("tiff: palette images are not supported");
  if (photometric != 1 && photometric != 2)
    fail("tiff: photometric interpretation " + std::to_string(photometric) +
         " is not supported (grey or RGB only)");
  const uint64_t base = photometric == 1 ? 1 : 3;
  if (spp != base + extra.size() || spp > 4)
    fail("tiff: " + std::to_string(spp) + " samples per pixel with " +
         std::to_string(extra.size()) + " extra samples do not fit photometric " +
         std::to_string(photometric));
  if (compression == 6 || compression == 7) fail("tiff: JPEG compression is not supported");
  if (compression != 1 && compression != 5 && compression != 8 && compression != 32946 &&
      compression != 32773)
    fail("tiff: compression " + std::to_string(compression) + " is not supported");
  if (predictor != 1 && predictor != 2)
    fail("tiff: predictor " + std::to_string(predictor) + " is not supported");
  if (rows_per_strip == 0) fail("tiff: RowsPerStrip is 0");
  if (rows_per_strip > height) rows_per_strip = height;
  const uint64_t n_strips = (height + rows_per_strip - 1) / rows_per_strip;
  if (offsets.size() != n_strips || counts.size() != n_strips)
    fail("tiff: " + std::to_string(offsets.size()) + " strip offsets and " +
         std::to_string(counts.size()) + " byte counts for " + std::to_string(n_strips) +
         " strips");
  for (uint64_t s = 0; s < n_strips; ++s)
    if (offsets[s] > buf.size() || counts[s] > buf.size() - offsets[s])
      fail("tiff: strip " + std::to_string(s) + " runs past the end of the file");

  const uint64_t row_bytes = width * spp;
  // before any allocation: an uncompressed strip must carry its rows, and a
  // compressed one cannot expand past its codec's largest ratio (PackBits
  // 128 bytes from 2, LZW at most 4096 bytes from each code of 9 bits or
  // more, Deflate 1032-fold)
  for (uint64_t s = 0; s < n_strips; ++s) {
    const uint64_t want = std::min(rows_per_strip, height - s * rows_per_strip) * row_bytes;
    const uint64_t n = counts[s];
    const uint64_t room = compression == 1       ? n
                          : compression == 32773 ? 64 * n
                          : compression == 5     ? (n * 8 / 9 + 1) * 4096
                                                 : (n + 1) * kDeflateMaxRatio;
    if (want > room)
      fail("tiff: strip " + std::to_string(s) + " of " + std::to_string(n) +
           " bytes cannot hold its " + std::to_string(want) + " bytes of pixels");
  }
  std::vector<uint8_t> px(row_bytes * height);
  for (uint64_t s = 0; s < n_strips; ++s) {
    const uint64_t rows = std::min(rows_per_strip, height - s * rows_per_strip);
    const size_t want = static_cast<size_t>(rows * row_bytes);
    uint8_t* dst = &px[s * rows_per_strip * row_bytes];
    const uint8_t* src = &buf[offsets[s]];
    const size_t n = static_cast<size_t>(counts[s]);
    size_t got;
    switch (compression) {
      case 1:
        got = n < want ? n : want;
        std::memcpy(dst, src, got);
        break;
      case 5: got = tiff_lzw(src, n, dst, want); break;
      case 32773: got = tiff_packbits(src, n, dst, want); break;
      default: {
        bool ended = false;  // a full strip is enough, as for libtiff
        got = inflate_into(src, n, dst, want, &ended, "tiff");
        break;
      }
    }
    if (got != want)
      fail("tiff: strip " + std::to_string(s) + " holds " + std::to_string(got) + " of " +
           std::to_string(want) + " bytes");
  }
  // horizontal differencing, per row and per sample; as in libtiff it is a
  // property of the LZW and Deflate codecs, ignored by the others
  if (predictor == 2 && (compression == 5 || compression == 8 || compression == 32946))
    for (uint64_t y = 0; y < height; ++y) {
      uint8_t* row = &px[y * row_bytes];
      for (uint64_t i = spp; i < row_bytes; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - spp]);
    }
  Image out;
  out.w = static_cast<int>(width);
  out.h = static_cast<int>(height);
  out.gray.resize(static_cast<size_t>(width * height));
  for (uint64_t i = 0; i < width * height; ++i) {
    const uint8_t* p = &px[i * spp];
    out.gray[i] = photometric == 1 ? p[0] : luma601(p[0], p[1], p[2]);
  }
  return out;
}

// The format comes from the file's first bytes, never from its name.
Image decode_impl(const char* path) {
  const std::vector<uint8_t> buf = read_file(path);
  if (buf.size() >= 8 && !std::memcmp(buf.data(), kPngSig, 8)) return decode_png(buf);
  if (buf.size() >= 2 && buf[0] == 'B' && buf[1] == 'M') return decode_bmp(buf);
  if (buf.size() >= 2 && buf[0] == 'P' && buf[1] == '5') return decode_pgm(buf);
  if (buf.size() >= 4 && ((!std::memcmp(buf.data(), "II*\0", 4)) ||
                          (!std::memcmp(buf.data(), "MM\0*", 4))))
    return decode_tiff(buf);
  fail("unknown image format");
}

// A malformed file must come back as a decode failure, never as an
// exception: one would cross the extern "C" / ctypes boundary (undefined
// behaviour) or escape a pool thread (std::terminate).
Image decode_any(const char* path) {
  try {
    return decode_impl(path);
  } catch (const DecodeError& e) {
    Image out;
    out.err = e.what;
    return out;
  } catch (const std::exception& e) {
    Image out;
    out.err = std::string("decode exception: ") + e.what();
    return out;
  } catch (...) {
    Image out;
    out.err = "decode exception";
    return out;
  }
}

void put_err(char* err, int err_len, const std::string& msg) {
  if (!err || err_len <= 0) return;
  const size_t n = msg.size() < static_cast<size_t>(err_len - 1) ? msg.size() : err_len - 1;
  std::memcpy(err, msg.data(), n);
  err[n] = '\0';
}

}  // namespace

extern "C" {

// Decode one file. On success *out holds a malloc'd h*w grey buffer that
// the caller frees with octave_free; on failure the reason is in err.
int octave_decode(const char* path, uint8_t** out, int* w, int* h, char* err, int err_len) {
  *out = nullptr;
  Image im = decode_any(path);
  if (!im.err.empty()) {
    put_err(err, err_len, im.err);
    return -1;
  }
  uint8_t* p = static_cast<uint8_t*>(std::malloc(im.gray.size()));
  if (!p) {
    put_err(err, err_len, "out of memory");
    return -1;
  }
  std::memcpy(p, im.gray.data(), im.gray.size());
  *out = p;
  *w = im.w;
  *h = im.h;
  return 0;
}

void octave_free(uint8_t* p) { std::free(p); }

// Decode n files (newline-joined paths) into out[n*h*w] with a pool of
// n_threads, nearest-resizing each to (h, w) where needed. A failed slot is
// zeroed. Returns the number of failures; the first failure's path and
// reason go to err.
int octave_load_batch(const char* joined_paths, int n, uint8_t* out, int w, int h,
                      int n_threads, char* err, int err_len) {
  std::vector<std::string> paths;
  const char* s = joined_paths;
  for (int i = 0; i < n; ++i) {
    const char* e = std::strchr(s, '\n');
    if (!e) e = s + std::strlen(s);
    paths.emplace_back(s, e - s);
    s = (*e) ? e + 1 : e;
  }
  std::atomic<int> next(0), failures(0);
  std::mutex err_lock;
  int first_failure = n;
  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      Image im = decode_any(paths[i].c_str());
      uint8_t* dst = out + static_cast<size_t>(i) * w * h;
      if (!im.err.empty()) {
        failures.fetch_add(1);
        std::memset(dst, 0, static_cast<size_t>(w) * h);
        std::lock_guard<std::mutex> g(err_lock);
        if (i < first_failure) {
          first_failure = i;
          put_err(err, err_len, paths[i] + ": " + im.err);
        }
        continue;
      }
      if (im.w == w && im.h == h) {
        std::memcpy(dst, im.gray.data(), static_cast<size_t>(w) * h);
      } else {
        for (int y = 0; y < h; ++y) {
          const int sy = static_cast<int>(static_cast<int64_t>(y) * im.h / h);
          for (int x = 0; x < w; ++x) {
            const int sx = static_cast<int>(static_cast<int64_t>(x) * im.w / w);
            dst[static_cast<size_t>(y) * w + x] = im.gray[static_cast<size_t>(sy) * im.w + sx];
          }
        }
      }
    }
  };
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  std::vector<std::thread> pool;
  try {
    for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  } catch (const std::system_error&) {
    // no more threads to be had: those started take every file
  }
  if (pool.empty()) worker();
  for (auto& th : pool) th.join();
  return failures.load();
}

}  // extern "C"
