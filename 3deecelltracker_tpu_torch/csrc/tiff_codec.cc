// Native TIFF codec + threaded volume loader.
//
// The reference leans on tifffile/PIL C internals for all image IO
// (SURVEY §2.2 N7).  This is the TPU build's native data-loader: a minimal,
// dependency-free reader for the data contract actually used by the
// pipeline — little-endian grayscale TIFFs, 8/16-bit, single-page slices or
// multi-page volumes (training data; these may also hold several samples a
// pixel, interleaved: PlanarConfiguration 1, e.g. RGB),
// uncompressed or LZW (incl. horizontal predictor), strip-based — plus a
// std::thread fan-out that decodes a whole z-stack in parallel, and an
// uncompressed writer for label output.
//
// Exposed via a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct TiffInfo {
  uint32_t width = 0, height = 0;
  uint16_t bits = 8, compression = 1, predictor = 1, samples = 1;
  uint16_t planar = 1;                  // PlanarConfiguration
  bool mixed_bits = false;              // samples of different depths
  std::vector<uint64_t> strip_offsets;
  std::vector<uint64_t> strip_counts;
  uint32_t rows_per_strip = 0;
};

bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(n));
  size_t got = std::fread(buf.data(), 1, buf.size(), f);
  std::fclose(f);
  return got == buf.size();
}

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

bool is_tiff_le(const std::vector<uint8_t>& d) {
  // little-endian classic TIFF only
  return d.size() >= 8 && d[0] == 'I' && d[1] == 'I' && rd16(&d[2]) == 42;
}

// parse the IFD at byte offset ifd; *next gets the next IFD's offset
// (0 after the last page)
bool parse_ifd_at(const std::vector<uint8_t>& d, uint32_t ifd,
                  TiffInfo* info, uint32_t* next) {
  if (uint64_t(ifd) + 2 > d.size()) return false;
  uint16_t n = rd16(&d[ifd]);
  uint64_t next_at = uint64_t(ifd) + 2 + 12 * uint64_t(n);
  *next = next_at + 4 <= d.size() ? rd32(&d[next_at]) : 0;
  // Every offset/count below comes from the (possibly truncated or
  // corrupt) file and must be bounds-checked before dereferencing — the
  // Python wrapper's contract is "fall back to PIL on error", which
  // requires parse failures to be error returns, not OOB reads.
  auto read_values = [&](uint32_t off, uint16_t type, uint32_t count,
                         std::vector<uint64_t>* out) -> bool {
    if (count == 0) return false;
    size_t size = (type == 3) ? 2 : 4;  // SHORT or LONG
    uint64_t need = uint64_t(count) * size;
    const uint8_t* src;
    uint32_t inline_off = off + 8;      // in bounds: off + 12 <= d.size()
    if (need <= 4) {
      src = &d[inline_off];
    } else {
      uint64_t value_off = rd32(&d[inline_off]);
      if (value_off + need > d.size()) return false;
      src = &d[value_off];
    }
    for (uint32_t i = 0; i < count; ++i) {
      out->push_back(size == 2 ? rd16(src + 2 * i) : rd32(src + 4 * i));
    }
    return true;
  };
  for (uint16_t i = 0; i < n; ++i) {
    uint64_t e64 = uint64_t(ifd) + 2 + 12 * uint64_t(i);
    if (e64 + 12 > d.size()) return false;
    uint32_t e = uint32_t(e64);
    uint16_t tag = rd16(&d[e]);
    uint16_t type = rd16(&d[e + 2]);
    uint32_t count = rd32(&d[e + 4]);
    std::vector<uint64_t> vals;
    switch (tag) {
      case 256: if (!read_values(e, type, count, &vals)) return false;
        info->width = vals[0]; break;
      case 257: if (!read_values(e, type, count, &vals)) return false;
        info->height = vals[0]; break;
      case 258: if (!read_values(e, type, count, &vals)) return false;
        info->bits = vals[0];
        for (uint64_t v : vals) info->mixed_bits |= v != vals[0];
        break;
      case 259: if (!read_values(e, type, count, &vals)) return false;
        info->compression = vals[0]; break;
      case 273: if (!read_values(e, type, count, &info->strip_offsets))
          return false;
        break;
      case 277: if (!read_values(e, type, count, &vals)) return false;
        info->samples = vals[0]; break;
      case 278: if (!read_values(e, type, count, &vals)) return false;
        info->rows_per_strip = vals[0]; break;
      case 279: if (!read_values(e, type, count, &info->strip_counts))
          return false;
        break;
      case 284: if (!read_values(e, type, count, &vals)) return false;
        info->planar = vals[0]; break;
      case 317: if (!read_values(e, type, count, &vals)) return false;
        info->predictor = vals[0]; break;
      default: break;
    }
  }
  if (info->rows_per_strip == 0) info->rows_per_strip = info->height;
  return info->width && info->height && !info->strip_offsets.empty();
}

bool parse_ifd(const std::vector<uint8_t>& d, TiffInfo* info) {
  uint32_t next;
  return is_tiff_le(d) && parse_ifd_at(d, rd32(&d[4]), info, &next);
}

// every page of a multi-page file, in order; at most max_pages, each IFD
// after the one before it (a chain that loops back is corrupt)
const uint32_t kMaxPages = 1u << 16;
const uint16_t kMaxSamples = 16;

// a grayscale page, 8 or 16 bits
bool grayscale(const TiffInfo& info) {
  return info.samples == 1 && (info.bits == 8 || info.bits == 16);
}

// a page of 1..kMaxSamples samples a pixel, interleaved, all of 8 or all
// of 16 bits
bool chunky(const TiffInfo& info) {
  return info.samples >= 1 && info.samples <= kMaxSamples &&
         (info.samples == 1 || info.planar == 1) && !info.mixed_bits &&
         (info.bits == 8 || info.bits == 16);
}

int parse_pages(const std::vector<uint8_t>& d, std::vector<TiffInfo>* pages) {
  if (!is_tiff_le(d)) return 2;
  uint32_t ifd = rd32(&d[4]);
  uint32_t prev = 0;
  while (ifd != 0) {
    if (pages->size() >= kMaxPages || (!pages->empty() && ifd <= prev))
      return 2;
    TiffInfo info;
    uint32_t next;
    if (!parse_ifd_at(d, ifd, &info, &next)) return 2;
    if (!chunky(info)) return 6;
    if (!pages->empty() && (info.width != (*pages)[0].width ||
                            info.height != (*pages)[0].height ||
                            info.bits != (*pages)[0].bits ||
                            info.samples != (*pages)[0].samples))
      return 7;
    pages->push_back(info);
    prev = ifd;
    ifd = next;
  }
  return pages->empty() ? 2 : 0;
}

// TIFF-variant LZW decode: MSB-first codes, Clear=256, EOI=257, early
// code-width change at table sizes 511/1023/2047.  Allocation-free hot
// loop: the string table is (parent code, tail byte, length) arrays and
// entries are emitted by walking parent pointers backwards.  Decoding
// stops once the strip is full, as libtiff's decoder does: the encoder
// below (and the JAX package's, the same source) writes EOI at the width
// before the decoder's last code-width change when the table ends one
// entry short of it, so a decoder that reads on after the last pixel can
// take EOI plus padding for a valid code.
bool lzw_decode(const uint8_t* src, size_t src_len, uint8_t* dst,
                size_t dst_len) {
  constexpr int kClear = 256, kEoi = 257, kMax = 4096;
  static thread_local uint16_t parent[kMax];
  static thread_local uint8_t tail[kMax];
  static thread_local uint8_t first[kMax];
  static thread_local uint32_t length[kMax];
  int next_code;
  auto reset = [&]() {
    for (int i = 0; i < 256; ++i) {
      parent[i] = 0xFFFF;
      tail[i] = uint8_t(i);
      first[i] = uint8_t(i);
      length[i] = 1;
    }
    next_code = 258;
  };
  reset();
  int bits = 9;
  uint64_t acc = 0;
  int acc_bits = 0;
  size_t si = 0, di = 0;
  int prev = -1;
  while (di < dst_len) {
    while (acc_bits < bits && si < src_len) {
      acc = (acc << 8) | src[si++];
      acc_bits += 8;
    }
    if (acc_bits < bits) break;
    int code = int((acc >> (acc_bits - bits)) & ((1u << bits) - 1));
    acc_bits -= bits;
    if (code == kEoi) break;
    if (code == kClear) {
      reset();
      bits = 9;
      prev = -1;
      continue;
    }
    uint32_t entry_len;
    uint8_t first_char;
    if (code < next_code && code != kClear && code != kEoi) {
      entry_len = length[code];
      first_char = first[code];
      if (di + entry_len > dst_len) return false;
      // emit by walking parents, writing back-to-front
      uint8_t* w = dst + di + entry_len;
      int c = code;
      while (true) {
        *--w = tail[c];
        uint16_t p = parent[c];
        if (p == 0xFFFF) break;
        c = p;
      }
    } else if (prev >= 0 && code == next_code) {
      // KwKwK case: entry = table[prev] + first(table[prev])
      entry_len = length[prev] + 1;
      first_char = first[prev];
      if (di + entry_len > dst_len) return false;
      uint8_t* w = dst + di + entry_len;
      *--w = first[prev];
      int c = prev;
      while (true) {
        *--w = tail[c];
        uint16_t p = parent[c];
        if (p == 0xFFFF) break;
        c = p;
      }
    } else {
      return false;
    }
    di += entry_len;
    if (prev >= 0 && next_code < kMax) {
      parent[next_code] = uint16_t(prev);
      tail[next_code] = first_char;
      first[next_code] = first[prev];
      length[next_code] = length[prev] + 1;
      ++next_code;
    }
    prev = code;
    if (next_code >= (1 << bits) - 1 && bits < 12) ++bits;
  }
  return di == dst_len;
}

// horizontal differencing undone, each sample against the same sample of
// the pixel before it
void undo_hpredictor(uint8_t* row, uint32_t width, uint16_t bits,
                     uint16_t samples) {
  size_t n = size_t(width) * samples;
  if (bits == 8) {
    for (size_t i = samples; i < n; ++i) row[i] += row[i - samples];
  } else {
    uint16_t* r = reinterpret_cast<uint16_t*>(row);
    for (size_t i = samples; i < n; ++i) r[i] += r[i - samples];
  }
}

// one page into out (width * height * samples uint16, samples innermost)
int decode_into(const TiffInfo& info, const std::vector<uint8_t>& d,
                uint16_t* out) {
  size_t bytes_per_px = size_t(info.bits / 8) * info.samples;
  size_t row_bytes = size_t(info.width) * bytes_per_px;
  std::vector<uint8_t> raw(row_bytes * info.height);
  size_t row0 = 0;
  for (size_t s = 0; s < info.strip_offsets.size(); ++s) {
    if (row0 >= info.height) break;     // more strips than rows: ignore
    uint32_t rows = std::min<uint32_t>(info.rows_per_strip,
                                       info.height - row0);
    size_t want = row_bytes * rows;
    if (!info.strip_counts.empty() && s >= info.strip_counts.size())
      return 3;
    size_t src_len = info.strip_counts.empty() ? want
                                               : info.strip_counts[s];
    // strip window must lie inside the file buffer (corrupt/truncated
    // files must fail with an error code, not read out of bounds)
    if (info.strip_offsets[s] + uint64_t(src_len) > d.size()) return 3;
    const uint8_t* src = &d[info.strip_offsets[s]];
    uint8_t* dst = raw.data() + row_bytes * row0;
    if (info.compression == 1) {
      if (src_len < want) return 3;
      std::memcpy(dst, src, want);
    } else if (info.compression == 5) {
      if (!lzw_decode(src, src_len, dst, want)) return 4;
    } else {
      return 5;  // unsupported compression
    }
    if (info.predictor == 2) {
      for (uint32_t r = 0; r < rows; ++r)
        undo_hpredictor(dst + row_bytes * r, info.width, info.bits,
                        info.samples);
    }
    row0 += rows;
  }
  size_t n = size_t(info.width) * info.height * info.samples;
  if (info.bits == 8) {
    for (size_t i = 0; i < n; ++i) out[i] = raw[i];
  } else {
    std::memcpy(out, raw.data(), n * 2);
  }
  return 0;
}

// TIFF-variant LZW encode (no predictor): MSB-first codes, emit Clear
// first, early code-width change (bump when next_code hits 511/1023/2047),
// table reset at 4094.  Dictionary is a versioned flat array over
// (prefix code, byte) so resets are O(1) — no memset per Clear.
void lzw_encode(const uint8_t* src, size_t n, std::vector<uint8_t>* out) {
  constexpr int kClear = 256, kEoi = 257, kResetAt = 4094;
  // entry: (version << 12) | code, keyed by prefix * 256 + byte
  static thread_local std::vector<uint32_t> table;
  static thread_local uint32_t version = 0;
  if (table.empty()) table.assign(4096 * 256, 0);
  uint64_t acc = 0;
  int acc_bits = 0;
  auto put = [&](int code, int bits) {
    acc = (acc << bits) | uint32_t(code);
    acc_bits += bits;
    while (acc_bits >= 8) {
      out->push_back(uint8_t(acc >> (acc_bits - 8)));
      acc_bits -= 8;
    }
  };
  int bits = 9;
  int next_code = 258;
  auto reset = [&]() {
    ++version;
    if (version == (1u << 20)) {  // version field is 20 bits
      std::fill(table.begin(), table.end(), 0u);
      version = 1;
    }
    bits = 9;
    next_code = 258;
  };
  reset();
  put(kClear, bits);
  if (n == 0) {
    put(kEoi, bits);
  } else {
    int prefix = src[0];
    for (size_t i = 1; i < n; ++i) {
      uint8_t c = src[i];
      uint32_t key = uint32_t(prefix) * 256u + c;
      uint32_t e = table[key];
      if ((e >> 12) == version) {
        prefix = int(e & 0xFFF);
        continue;
      }
      put(prefix, bits);
      table[key] = (version << 12) | uint32_t(next_code);
      ++next_code;
      // the decoder defines each entry one code later than the encoder,
      // so its width check (next_code >= (1<<bits)-1) fires at the same
      // stream position as this one
      if (next_code == (1 << bits) && bits < 12) ++bits;
      if (next_code >= kResetAt) {
        put(kClear, bits);
        reset();
      }
      prefix = c;
    }
    put(prefix, bits);
    put(kEoi, bits);
  }
  if (acc_bits > 0)
    out->push_back(uint8_t(acc << (8 - acc_bits)));
}

// shared writer core: n_pages same-shaped single-strip grayscale pages,
// optional LZW, as one TIFF (n_pages = 1: the recording's slice files).
// Layout: header, then per page its strip and its IFD, each IFD pointing
// at the next.
int write_pages(const char* path, const uint16_t* data, int n_pages,
                int width, int height, int bits, int compression) {
  if (bits != 8 && bits != 16) return 6;
  if (compression != 1 && compression != 5) return 5;
  if (n_pages < 1) return 7;
  size_t bpp = bits / 8;
  size_t n_px = size_t(width) * height;
  size_t raw_bytes = n_px * bpp;
  std::vector<std::vector<uint8_t>> payloads(n_pages);
  for (int k = 0; k < n_pages; ++k) {
    const uint16_t* page = data + n_px * k;
    std::vector<uint8_t> px(raw_bytes);
    if (bits == 8) {
      for (size_t i = 0; i < n_px; ++i) px[i] = uint8_t(page[i]);
    } else {
      std::memcpy(px.data(), page, raw_bytes);
    }
    if (compression == 5) {
      payloads[k].reserve(raw_bytes / 2);
      lzw_encode(px.data(), raw_bytes, &payloads[k]);
    } else {
      payloads[k] = std::move(px);
    }
  }
  const uint16_t n_entries = 8;
  const uint32_t ifd_bytes = 2 + 12 * n_entries + 4;
  std::vector<uint32_t> data_off(n_pages), ifd_off(n_pages);
  uint64_t pos = 8;
  for (int k = 0; k < n_pages; ++k) {
    data_off[k] = uint32_t(pos);
    pos += payloads[k].size();
    if (pos & 1) ++pos;
    ifd_off[k] = uint32_t(pos);
    pos += ifd_bytes;
  }
  if (pos > 0xFFFFFFFFull) return 8;
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  uint8_t header[8] = {'I', 'I', 42, 0};
  std::memcpy(header + 4, &ifd_off[0], 4);
  std::fwrite(header, 1, 8, f);
  auto entry = [&](uint16_t tag, uint16_t type, uint32_t count,
                   uint32_t value) {
    std::fwrite(&tag, 2, 1, f);
    std::fwrite(&type, 2, 1, f);
    std::fwrite(&count, 4, 1, f);
    std::fwrite(&value, 4, 1, f);
  };
  for (int k = 0; k < n_pages; ++k) {
    const std::vector<uint8_t>& payload = payloads[k];
    std::fwrite(payload.data(), 1, payload.size(), f);
    if ((data_off[k] + payload.size()) & 1) std::fputc(0, f);
    std::fwrite(&n_entries, 2, 1, f);
    entry(256, 3, 1, width);                    // ImageWidth
    entry(257, 3, 1, height);                   // ImageLength
    entry(258, 3, 1, bits);                     // BitsPerSample
    entry(259, 3, 1, compression);              // Compression
    entry(262, 3, 1, 1);                        // Photometric: BlackIsZero
    entry(273, 4, 1, data_off[k]);              // StripOffsets
    entry(278, 3, 1, height);                   // RowsPerStrip
    entry(279, 4, 1, uint32_t(payload.size())); // StripByteCounts
    uint32_t next = k + 1 < n_pages ? ifd_off[k + 1] : 0;
    std::fwrite(&next, 4, 1, f);
  }
  std::fclose(f);
  return 0;
}

int write_tiff(const char* path, const uint16_t* data, int width,
               int height, int bits, int compression) {
  return write_pages(path, data, 1, width, height, bits, compression);
}

}  // namespace

extern "C" {

// the page count and the (shared) size, depth and samples a pixel of a
// multi-page TIFF
int t3dct_tiff_pages(const char* path, int* n_pages, int* width,
                     int* height, int* bits, int* samples) {
  std::vector<uint8_t> d;
  if (!read_file(path, d)) return 1;
  std::vector<TiffInfo> pages;
  int rc = parse_pages(d, &pages);
  if (rc) return rc;
  *n_pages = int(pages.size());
  *width = int(pages[0].width);
  *height = int(pages[0].height);
  *bits = int(pages[0].bits);
  *samples = int(pages[0].samples);
  return 0;
}

// decode every page into out (n_pages * width * height * samples uint16,
// samples innermost), after checking that the file holds n_pages pages of
// that size
int t3dct_tiff_read_pages(const char* path, uint16_t* out, int n_pages,
                          int width, int height, int samples) {
  std::vector<uint8_t> d;
  if (!read_file(path, d)) return 1;
  std::vector<TiffInfo> pages;
  int rc = parse_pages(d, &pages);
  if (rc) return rc;
  if (int(pages.size()) != n_pages || int(pages[0].width) != width ||
      int(pages[0].height) != height || int(pages[0].samples) != samples)
    return 7;
  size_t stride = size_t(width) * height * samples;
  for (int i = 0; i < n_pages; ++i) {
    rc = decode_into(pages[i], d, out + stride * i);
    if (rc) return rc;
  }
  return 0;
}

// returns 0 on success; fills width/height/bits
int t3dct_tiff_info(const char* path, int* width, int* height, int* bits) {
  std::vector<uint8_t> d;
  if (!read_file(path, d)) return 1;
  TiffInfo info;
  if (!parse_ifd(d, &info)) return 2;
  if (!grayscale(info)) return 6;
  *width = int(info.width);
  *height = int(info.height);
  *bits = int(info.bits);
  return 0;
}

// decode one image into a caller uint16 buffer of width*height elements
int t3dct_tiff_read(const char* path, uint16_t* out) {
  std::vector<uint8_t> d;
  if (!read_file(path, d)) return 1;
  TiffInfo info;
  if (!parse_ifd(d, &info)) return 2;
  if (!grayscale(info)) return 6;
  return decode_into(info, d, out);
}

// decode n same-shaped slices in parallel into out (n * w * h uint16);
// every slice's parsed dimensions must equal (width, height) — the
// caller sizes the buffer from the FIRST slice only, so a stray
// different-shaped TIFF in the glob must be an error (7), not a heap
// overflow past its stride slot
int t3dct_tiff_read_volume(const char** paths, int n, uint16_t* out,
                           int width, int height, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;
  std::vector<int> status(n, 0);
  size_t stride = size_t(width) * height;
  auto read_checked = [&](const char* path, uint16_t* slot) -> int {
    std::vector<uint8_t> d;
    if (!read_file(path, d)) return 1;
    TiffInfo info;
    if (!parse_ifd(d, &info)) return 2;
    if (!grayscale(info)) return 6;
    if (int(info.width) != width || int(info.height) != height) return 7;
    return decode_into(info, d, slot);
  };
  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      status[i] = read_checked(paths[i], out + stride * i);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& t : threads) t.join();
  for (int s : status)
    if (s) return s;
  return 0;
}

// write n_pages same-shaped grayscale pages (bits 8 or 16; compression
// 1=none, 5=LZW) as one multi-page TIFF; data is n_pages * width * height
// uint16 values
int t3dct_tiff_write_pages(const char* path, const uint16_t* data,
                           int n_pages, int width, int height, int bits,
                           int compression) {
  return write_pages(path, data, n_pages, width, height, bits, compression);
}

// write an LZW-compressed grayscale TIFF (bits 8 or 16)
int t3dct_tiff_write_lzw(const char* path, const uint16_t* data, int width,
                         int height, int bits) {
  return write_tiff(path, data, width, height, bits, 5);
}

// write n same-shaped slices in parallel (compression 1=none, 5=LZW);
// data is n * width * height uint16 values
int t3dct_tiff_write_volume(const char** paths, int n, const uint16_t* data,
                            int width, int height, int bits,
                            int compression, int n_threads) {
  if (n_threads <= 0) n_threads = std::thread::hardware_concurrency();
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;
  std::vector<int> status(n, 0);
  size_t stride = size_t(width) * height;
  auto worker = [&](int tid) {
    for (int i = tid; i < n; i += n_threads) {
      status[i] = write_tiff(paths[i], data + stride * i, width, height,
                             bits, compression);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker, t);
  for (auto& t : threads) t.join();
  for (int s : status)
    if (s) return s;
  return 0;
}

// write an uncompressed grayscale TIFF (bits 8 or 16)
int t3dct_tiff_write(const char* path, const uint16_t* data, int width,
                     int height, int bits) {
  if (bits != 8 && bits != 16) return 6;
  size_t bpp = bits / 8;
  size_t payload = size_t(width) * height * bpp;
  std::vector<uint8_t> px(payload);
  if (bits == 8) {
    for (size_t i = 0; i < size_t(width) * height; ++i)
      px[i] = uint8_t(data[i]);
  } else {
    std::memcpy(px.data(), data, payload);
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  uint32_t data_off = 8;
  uint32_t ifd_off = data_off + uint32_t(payload);
  if (ifd_off & 1) ++ifd_off;
  uint8_t header[8] = {'I', 'I', 42, 0};
  std::memcpy(header + 4, &ifd_off, 4);
  std::fwrite(header, 1, 8, f);
  std::fwrite(px.data(), 1, payload, f);
  if ((data_off + payload) & 1) std::fputc(0, f);

  auto entry = [&](uint16_t tag, uint16_t type, uint32_t count,
                   uint32_t value) {
    std::fwrite(&tag, 2, 1, f);
    std::fwrite(&type, 2, 1, f);
    std::fwrite(&count, 4, 1, f);
    std::fwrite(&value, 4, 1, f);
  };
  uint16_t n_entries = 8;
  std::fwrite(&n_entries, 2, 1, f);
  entry(256, 3, 1, width);                 // ImageWidth
  entry(257, 3, 1, height);                // ImageLength
  entry(258, 3, 1, bits);                  // BitsPerSample
  entry(259, 3, 1, 1);                     // Compression: none
  entry(262, 3, 1, 1);                     // Photometric: BlackIsZero
  entry(273, 4, 1, data_off);              // StripOffsets
  entry(278, 3, 1, height);                // RowsPerStrip
  entry(279, 4, 1, uint32_t(payload));     // StripByteCounts
  uint32_t next = 0;
  std::fwrite(&next, 4, 1, f);
  std::fclose(f);
  return 0;
}

// Exact 65536-bin histogram of a uint16 buffer (counts must hold 65536
// uint64 slots, caller-zeroed or not — it is overwritten).  Runs at
// memory bandwidth with the GIL released (ctypes), replacing numpy's
// intp-converting bincount on the per-volume percentile-normalization
// scan (csbdeep normalize percentiles, stardistwrapper.py:71) — the
// dominant host-CPU cost of the pipeline's prefetch thread on a 1-core
// host.  Four interleaved sub-tables break the store-to-load dependency
// on repeated values.
int t3dct_hist_u16(const uint16_t* data, long long n, uint64_t* counts) {
  if (n < 0) return 1;
  std::vector<uint64_t> sub(4 * 65536, 0);
  uint64_t* s0 = sub.data();
  uint64_t* s1 = s0 + 65536;
  uint64_t* s2 = s1 + 65536;
  uint64_t* s3 = s2 + 65536;
  long long i = 0;
  for (; i + 4 <= n; i += 4) {
    s0[data[i]]++;
    s1[data[i + 1]]++;
    s2[data[i + 2]]++;
    s3[data[i + 3]]++;
  }
  for (; i < n; ++i) s0[data[i]]++;
  for (int v = 0; v < 65536; ++v)
    counts[v] = s0[v] + s1[v] + s2[v] + s3[v];
  return 0;
}

// 8-bit transport quantization of a raw uint16 volume against its
// host-computed normalization percentiles:
// out = round_half_up(clip((x - mi) / (ma - mi) * 255, 0, 255)).
// Used by the opt-in transport="u8" pipeline path (halves the
// host->device bytes through a remote TPU link; the device normalizes
// with norm_minmax=(0,255) so no device code changes).  A 65536-entry
// LUT makes the pass pure memory bandwidth; the Python fallback builds
// the identical f32 LUT so native/numpy results are bit-identical.
int t3dct_quantize_u8(const uint16_t* data, long long n, float mi,
                      float ma, uint8_t* out) {
  if (n < 0) return 1;
  const float scale = 255.0f / (ma - mi + 1e-20f);
  std::vector<uint8_t> lut(65536);
  for (int v = 0; v < 65536; ++v) {
    float q = (static_cast<float>(v) - mi) * scale;
    q = q < 0.0f ? 0.0f : (q > 255.0f ? 255.0f : q);
    lut[v] = static_cast<uint8_t>(q + 0.5f);
  }
  for (long long i = 0; i < n; ++i) out[i] = lut[data[i]];
  return 0;
}

}  // extern "C"
