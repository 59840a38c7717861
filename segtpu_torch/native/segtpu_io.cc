// Grayscale strip-TIFF reader with a threaded batch decode: the port's own
// copy of the JAX package's native/segtpu_io.cc.
//
// The host-side stage of the input pipeline (file -> uint8 array). The
// reference leans on OpenCV's C++ core through Python (`cv2.imread`,
// dataset.py:46); this is a dependency-free strip-TIFF reader (8/16-bit,
// one sample; none, LZW with predictor 2, PackBits) plus a thread pool for
// batch decode, exposed through a C ABI that segtpu_torch/data/native.py
// loads with ctypes. A file it does not support returns an error code.
//
// Built at first use by segtpu_torch/data/native.py:
//   g++ -O3 -shared -fPIC -std=c++17 -pthread -o libsegtpu_io.so segtpu_io.cc

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

// Size sanity bounds for header-declared dimensions (see decode_tiff_gray
// and probe_file): largest supported gray image is 512 MPix / 64k a side.
constexpr uint32_t kMaxDim = 65536;
constexpr size_t kMaxPixels = (size_t)512 << 20;

struct Reader {
  const uint8_t* p;
  size_t n;
  bool little;
  bool ok = true;

  uint16_t u16(size_t off) const {
    if (off + 2 > n) return 0;
    return little ? (uint16_t)(p[off] | p[off + 1] << 8)
                  : (uint16_t)(p[off] << 8 | p[off + 1]);
  }
  uint32_t u32(size_t off) const {
    if (off + 4 > n) return 0;
    return little ? ((uint32_t)p[off] | (uint32_t)p[off + 1] << 8 |
                     (uint32_t)p[off + 2] << 16 | (uint32_t)p[off + 3] << 24)
                  : ((uint32_t)p[off] << 24 | (uint32_t)p[off + 1] << 16 |
                     (uint32_t)p[off + 2] << 8 | (uint32_t)p[off + 3]);
  }
};

struct Entry {
  uint16_t tag, type;
  uint32_t count, value_off;
};

// Read one IFD entry's integer values (SHORT or LONG arrays).
static bool read_values(const Reader& r, const Entry& e, size_t entry_off,
                        std::vector<uint32_t>* out) {
  size_t elem = (e.type == 3) ? 2 : (e.type == 4) ? 4 : 0;
  if (!elem) return false;
  size_t total = elem * e.count;
  size_t base = (total <= 4) ? entry_off + 8 : e.value_off;
  out->resize(e.count);
  for (uint32_t i = 0; i < e.count; i++) {
    (*out)[i] = (e.type == 3) ? r.u16(base + i * 2) : r.u32(base + i * 4);
  }
  return true;
}

// ---------------------------------------------------------- decompressors

// PackBits (TIFF compression 32773): control byte c in [0,127] copies c+1
// literals; c in [129,255] repeats the next byte 257-c times; 128 is a noop.
static bool packbits_decode(const uint8_t* src, size_t n,
                            std::vector<uint8_t>* out, size_t expect) {
  size_t i = 0;
  while (i < n && out->size() < expect) {
    uint8_t c = src[i++];
    if (c < 128) {
      size_t cnt = (size_t)c + 1;
      if (i + cnt > n) return false;
      out->insert(out->end(), src + i, src + i + cnt);
      i += cnt;
    } else if (c > 128) {
      if (i >= n) return false;
      out->insert(out->end(), 257 - (size_t)c, src[i++]);
    }  // c == 128: noop
  }
  return out->size() >= expect;
}

// TIFF LZW (compression 5): MSB-first codes, Clear=256, EOI=257, first
// dynamic code 258, 9→12 bit widths with the TIFF "early change" (width
// bumps when the next free code reaches 2^width − 1).
static bool lzw_decode(const uint8_t* src, size_t n,
                       std::vector<uint8_t>* out, size_t expect) {
  static const int kClear = 256, kEoi = 257;
  std::vector<int32_t> prev(4096, -1);
  std::vector<uint8_t> last(4096, 0);
  int next_code = 258, width = 9;
  uint32_t window = 0;
  int avail = 0;
  size_t pos = 0;

  auto read_code = [&]() -> int {
    while (avail < width) {
      if (pos >= n) return kEoi;
      window = (window << 8) | src[pos++];
      avail += 8;
    }
    int code = (int)((window >> (avail - width)) & ((1u << width) - 1));
    avail -= width;
    return code;
  };
  auto first_byte = [&](int code) -> uint8_t {
    while (code >= 256) code = prev[code];
    return (uint8_t)code;
  };
  auto emit = [&](int code) {
    size_t start = out->size();
    int c = code;
    while (c >= 0) {
      if (c < 256) {
        out->push_back((uint8_t)c);
        break;
      }
      out->push_back(last[c]);
      c = prev[c];
    }
    std::reverse(out->begin() + start, out->end());
  };

  int old = -1;
  for (;;) {
    int code = read_code();
    if (code == kEoi) break;
    if (code == kClear) {
      next_code = 258;
      width = 9;
      old = -1;
      continue;
    }
    if (old < 0) {
      if (code >= 256) return false;
      emit(code);
      old = code;
    } else {
      if (code < next_code) {
        if (next_code < 4096) {
          prev[next_code] = old;
          last[next_code] = first_byte(code);
          next_code++;
        }
        emit(code);
      } else if (code == next_code && next_code < 4096) {
        prev[next_code] = old;
        last[next_code] = first_byte(old);
        next_code++;
        emit(code);
      } else {
        return false;
      }
      old = code;
    }
    if (next_code == (1 << width) - 1 && width < 12) width++;
    if (out->size() >= expect) break;
  }
  return out->size() >= expect;
}

// Horizontal differencing predictor (tag 317 == 2), applied per row after
// decompression, per sample (8- or 16-bit).
static void undo_predictor(uint8_t* row, size_t width, size_t bits,
                           bool little) {
  if (bits == 8) {
    for (size_t i = 1; i < width; i++) row[i] = (uint8_t)(row[i] + row[i - 1]);
  } else {
    uint16_t acc = little ? (uint16_t)(row[0] | row[1] << 8)
                          : (uint16_t)(row[0] << 8 | row[1]);
    for (size_t i = 1; i < width; i++) {
      uint16_t v = little ? (uint16_t)(row[2 * i] | row[2 * i + 1] << 8)
                          : (uint16_t)(row[2 * i] << 8 | row[2 * i + 1]);
      acc = (uint16_t)(acc + v);
      if (little) {
        row[2 * i] = (uint8_t)(acc & 0xFF);
        row[2 * i + 1] = (uint8_t)(acc >> 8);
      } else {
        row[2 * i] = (uint8_t)(acc >> 8);
        row[2 * i + 1] = (uint8_t)(acc & 0xFF);
      }
    }
  }
}

// Decode an 8-bit (or 16-bit, downshifted) grayscale strip TIFF.
// Compressions: none (1), LZW (5, incl. predictor 2), PackBits (32773).
// Returns 0 on success; fills *w/*h and writes into out (capacity cap).
static int decode_tiff_gray(const uint8_t* buf, size_t len, uint8_t* out,
                            size_t cap, int32_t* w, int32_t* h) {
  if (len < 8) return -1;
  Reader r{buf, len, buf[0] == 'I'};
  if (!((buf[0] == 'I' && buf[1] == 'I') || (buf[0] == 'M' && buf[1] == 'M')))
    return -2;
  if (r.u16(2) != 42) return -2;
  size_t ifd = r.u32(4);
  if (ifd + 2 > len) return -3;
  uint16_t n_entries = r.u16(ifd);

  uint32_t width = 0, height = 0, bits = 1, comp = 1, spp = 1;
  uint32_t rows_per_strip = 0xFFFFFFFF, predictor = 1;
  std::vector<uint32_t> offsets, counts;

  for (uint16_t i = 0; i < n_entries; i++) {
    size_t eo = ifd + 2 + i * 12;
    Entry e{r.u16(eo), r.u16(eo + 2), r.u32(eo + 4), r.u32(eo + 8)};
    std::vector<uint32_t> vals;
    switch (e.tag) {
      case 256: read_values(r, e, eo, &vals); if (!vals.empty()) width = vals[0]; break;
      case 257: read_values(r, e, eo, &vals); if (!vals.empty()) height = vals[0]; break;
      case 258: read_values(r, e, eo, &vals); if (!vals.empty()) bits = vals[0]; break;
      case 259: read_values(r, e, eo, &vals); if (!vals.empty()) comp = vals[0]; break;
      case 273: read_values(r, e, eo, &offsets); break;
      case 277: read_values(r, e, eo, &vals); if (!vals.empty()) spp = vals[0]; break;
      case 278: read_values(r, e, eo, &vals); if (!vals.empty()) rows_per_strip = vals[0]; break;
      case 279: read_values(r, e, eo, &counts); break;
      case 317: read_values(r, e, eo, &vals); if (!vals.empty()) predictor = vals[0]; break;
      default: break;
    }
  }
  if (!width || !height || offsets.empty()) return -4;
  if (comp != 1 && comp != 5 && comp != 32773) return -5;
  if (spp != 1) return -6;                  // grayscale only
  if (bits != 8 && bits != 16) return -7;
  if (predictor != 1 && predictor != 2) return -10;
  // Header-driven size sanity bound: a corrupt/adversarial file with huge
  // declared dimensions must be a clean rejection (error code), not a
  // multi-GB allocation / decompression bomb.
  if (width > kMaxDim || height > kMaxDim) return -13;
  size_t need = (size_t)width * height;
  if (need > kMaxPixels || need > cap) return -8;

  size_t bytes_per_px = bits / 8;
  size_t row_bytes = (size_t)width * bytes_per_px;
  size_t written_rows = 0;
  std::vector<uint8_t> scratch;
  for (size_t s = 0; s < offsets.size() && written_rows < height; s++) {
    size_t off = offsets[s];
    size_t strip_rows = rows_per_strip == 0xFFFFFFFF
                            ? height
                            : rows_per_strip;
    size_t rows = std::min<size_t>(strip_rows, height - written_rows);
    size_t want = rows * row_bytes;
    size_t src_bytes = (s < counts.size()) ? counts[s]
                                           : (comp == 1 ? want : 0);
    if (!src_bytes || off + src_bytes > len) return -9;

    const uint8_t* strip = nullptr;
    if (comp == 1) {
      // The row loop below reads the full rows*row_bytes from the mmap;
      // a truncated strip must be rejected here, not read out of bounds
      // (worst case SIGBUS past the last mapped page).
      if (src_bytes < want) return -9;
      strip = buf + off;
    } else {
      scratch.clear();
      scratch.reserve(want);
      bool ok = (comp == 5)
                    ? lzw_decode(buf + off, src_bytes, &scratch, want)
                    : packbits_decode(buf + off, src_bytes, &scratch, want);
      if (!ok) return -11;
      strip = scratch.data();
    }

    for (size_t row = 0; row < rows; row++) {
      const uint8_t* sp = strip + row * row_bytes;
      uint8_t* dp = out + (written_rows + row) * width;
      if (predictor == 2) {
        if (strip != scratch.data()) {  // uncompressed: copy before undoing
          scratch.assign(sp, sp + row_bytes);
          sp = scratch.data();
        }
        undo_predictor(const_cast<uint8_t*>(sp), width, bits, r.little);
      }
      if (bits == 8) {
        memcpy(dp, sp, width);
      } else {
        for (size_t k = 0; k < width; k++) {
          uint16_t v = r.little ? (uint16_t)(sp[2 * k] | sp[2 * k + 1] << 8)
                                : (uint16_t)(sp[2 * k] << 8 | sp[2 * k + 1]);
          dp[k] = (uint8_t)(v >> 8);
        }
      }
    }
    written_rows += rows;
  }
  // A malformed file (RowsPerStrip=0, short strip list) must not report
  // success with uninitialized output rows.
  if (written_rows < height) return -12;
  *w = (int32_t)width;
  *h = (int32_t)height;
  return 0;
}

// mmap the file read-only: zero-copy access for the (dominant)
// uncompressed-strip case instead of a full read into a buffer.
struct Mapped {
  const uint8_t* p = nullptr;
  size_t n = 0;
  bool ok() const { return p != nullptr; }
  ~Mapped() {
    if (p) munmap(const_cast<uint8_t*>(p), n);
  }
};

static Mapped map_file(const char* path) {
  Mapped m;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return m;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0) {
    close(fd);
    return m;
  }
  void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (p == MAP_FAILED) return m;
  m.p = (const uint8_t*)p;
  m.n = (size_t)st.st_size;
  return m;
}

static int decode_file(const char* path, uint8_t* out, size_t cap,
                       int32_t* w, int32_t* h) {
  Mapped m = map_file(path);
  if (!m.ok()) return -100;
  return decode_tiff_gray(m.p, m.n, out, cap, w, h);
}

// Parse only the IFD to get dimensions (and supportability) without
// decoding pixel data — lets callers allocate exactly.
static int probe_file(const char* path, int32_t* w, int32_t* h) {
  // mmap instead of a bounded head read: libtiff writers commonly place
  // the IFD at the END of the file, so the IFD offset can be anywhere.
  // Only the touched pages are actually faulted in.
  Mapped m = map_file(path);
  if (!m.ok()) return -100;
  size_t got = m.n;
  const uint8_t* head = m.p;
  if (got < 8) return -1;
  Reader r{head, got, head[0] == 'I'};
  if (!((head[0] == 'I' && head[1] == 'I') ||
        (head[0] == 'M' && head[1] == 'M')) ||
      r.u16(2) != 42)
    return -2;
  size_t ifd = r.u32(4);
  if (ifd + 2 > got) return -3;
  uint16_t n_entries = r.u16(ifd);
  uint32_t width = 0, height = 0, bits = 1, comp = 1, spp = 1, pred = 1;
  for (uint16_t i = 0; i < n_entries; i++) {
    size_t eo = ifd + 2 + i * 12;
    if (eo + 12 > got) return -3;
    Entry e{r.u16(eo), r.u16(eo + 2), r.u32(eo + 4), r.u32(eo + 8)};
    std::vector<uint32_t> vals;
    switch (e.tag) {
      case 256: read_values(r, e, eo, &vals); if (!vals.empty()) width = vals[0]; break;
      case 257: read_values(r, e, eo, &vals); if (!vals.empty()) height = vals[0]; break;
      case 258: read_values(r, e, eo, &vals); if (!vals.empty()) bits = vals[0]; break;
      case 259: read_values(r, e, eo, &vals); if (!vals.empty()) comp = vals[0]; break;
      case 277: read_values(r, e, eo, &vals); if (!vals.empty()) spp = vals[0]; break;
      case 317: read_values(r, e, eo, &vals); if (!vals.empty()) pred = vals[0]; break;
      default: break;
    }
  }
  if (!width || !height) return -4;
  if (comp != 1 && comp != 5 && comp != 32773) return -5;
  if (spp != 1) return -6;
  if (bits != 8 && bits != 16) return -7;
  if (pred != 1 && pred != 2) return -10;
  if (width > kMaxDim || height > kMaxDim ||
      (size_t)width * height > kMaxPixels)
    return -13;
  *w = (int32_t)width;
  *h = (int32_t)height;
  return 0;
}

}  // namespace

extern "C" {

// Single-file decode. Returns 0 on success (see codes above).
int segtpu_decode_gray(const char* path, uint8_t* out, int64_t cap,
                       int32_t* w, int32_t* h) {
  return decode_file(path, out, (size_t)cap, w, h);
}

// Header-only probe: fills *w/*h if the file is a supported TIFF.
int segtpu_probe_gray(const char* path, int32_t* w, int32_t* h) {
  return probe_file(path, w, h);
}

// Batch decode into caller-provided per-image offsets (exact allocation —
// pair with segtpu_probe_gray). out + offsets[i] has caps[i] bytes.
void segtpu_decode_batch_at(const char** paths, int32_t n, uint8_t* out,
                            const int64_t* offsets, const int64_t* caps,
                            int32_t* dims, int32_t* status,
                            int32_t n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<std::thread> pool;
  std::atomic<int32_t> next(0);
  auto work = [&]() {
    for (;;) {
      int32_t i = next.fetch_add(1);
      if (i >= n) break;
      int32_t w = 0, h = 0;
      status[i] = decode_file(paths[i], out + offsets[i], (size_t)caps[i],
                              &w, &h);
      dims[2 * i] = h;
      dims[2 * i + 1] = w;
    }
  };
  int32_t workers = std::min(n_threads, n);
  for (int32_t t = 0; t < workers; t++) pool.emplace_back(work);
  for (auto& th : pool) th.join();
}

}  // extern "C"
