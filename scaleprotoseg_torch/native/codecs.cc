// Image decoders for the offline preprocessing and the serve CLI: the
// pixel work of PNG, JPEG and TIFF, bit-equal to what Pillow 12 returns
// (libjpeg-turbo 3.1 for JPEG, libtiff 4.7 for compressed TIFF).
//
// Built with g++ at first use (scaleprotoseg_torch/native/__init__.py) and
// bound with ctypes (scaleprotoseg_torch/codecs.py), which parses the PNG
// and TIFF containers and inflates zlib streams with Python's zlib.  This
// file does what a Python loop cannot do fast:
//   - PNG: undoing the five scanline filters;
//   - JPEG: the whole decoder, following libjpeg-turbo's default
//     decompression: baseline and progressive Huffman scans, the islow
//     IDCT (jidctint.c), fancy upsampling (jdsample.c) and the YCbCr ->
//     RGB tables (jdcolor.c);
//   - TIFF: LZW and PackBits strips.
// Every entry point returns 0 (or a byte count) on success and a negative
// value on failure, with a message naming the unsupported feature or the
// fault in ``err``.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

void set_err(char* err, int errlen, const std::string& msg) {
  if (err == nullptr || errlen <= 0) return;
  std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

// ---------------------------------------------------------------------------
// PNG
// ---------------------------------------------------------------------------
inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// ---------------------------------------------------------------------------
// JPEG
// ---------------------------------------------------------------------------
struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// zigzag position -> natural (row-major) index, with 16 spare entries so
// that a corrupt run length lands on 63 (as jpeg_natural_order does)
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  uint8_t values[256];
  int nvalues = 0;
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // values index = code + valoffset[len]
  // 9-bit lookahead: (length << 8) | value, 0 when the code is longer
  uint16_t look[512];
};

void build_huffman(Huffman& h, const uint8_t* counts, const uint8_t* vals,
                   int nvals) {
  h.defined = true;
  h.nvalues = nvals;
  std::memcpy(h.values, vals, (size_t)nvals);
  std::memset(h.look, 0, sizeof(h.look));
  int code = 0, k = 0;
  for (int len = 1; len <= 16; len++) {
    int n = counts[len - 1];
    if (n) {
      h.valoffset[len] = k - code;
      for (int i = 0; i < n; i++, k++, code++) {
        if (len <= 9) {
          int shift = 9 - len;
          for (int f = 0; f < (1 << shift); f++)
            h.look[(code << shift) | f] =
                (uint16_t)((len << 8) | h.values[k]);
        }
      }
      h.maxcode[len] = code - 1;
    } else {
      h.maxcode[len] = -1;
    }
    if (code > (1 << len))
      throw JpegError("corrupt Huffman table (code space overflow)");
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;  // sentinel: a corrupt code ends the search
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;   // blocks held (the MCU-padded grid)
  int dw = 0, dh = 0;   // downsampled size in samples
  bool latched = false;
  uint16_t qt[64];      // latched quantization table, natural order
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
  int coef_bits[64];    // Al of the last scan of each zigzag position
};

class Jpeg {
 public:
  Jpeg(const uint8_t* data, int64_t len) : d_(data), n_(len) {}

  void read_header() {
    if (n_ < 4 || d_[0] != 0xFF || d_[1] != 0xD8)
      throw JpegError("not a JPEG file (no SOI marker)");
    pos_ = 2;
    while (!frame_) {
      int m = next_marker();
      if (m == 0xDA) throw JpegError("corrupt JPEG: scan before the frame");
      handle_marker(m);
    }
  }

  void decode(uint8_t* out) {
    bool eoi = false;
    while (!eoi) {
      int m = next_marker();
      if (m == 0xD9) {
        eoi = true;
      } else if (m == 0xDA) {
        read_sos();
        if (!progressive_ && scans_done_all()) break;
      } else {
        handle_marker(m);
      }
    }
    if (progressive_) check_smoothing();
    output(out);
  }

  int width = 0, height = 0, ncomp = 0;

 private:
  const uint8_t* d_;
  int64_t n_;
  int64_t pos_ = 0;
  bool frame_ = false, progressive_ = false;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  int restart_interval_ = 0;
  uint16_t qtables_[4][64];
  bool qdefined_[4] = {false, false, false, false};
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;
  int max_h_ = 1, max_v_ = 1, mcus_x_ = 0, mcus_y_ = 0;
  int64_t sequential_components_done_ = 0;

  // bit reader state
  uint64_t acc_ = 0;
  int nbits_ = 0;
  int pad_bits_ = 0;     // zero bits appended past the scan's data
  bool at_marker_ = false, at_eof_ = false, insufficient_ = false;

  uint8_t byte() {
    if (pos_ >= n_) throw JpegError("image file is truncated");
    return d_[pos_++];
  }
  int u16() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {
    // skip anything up to 0xFF, then fill bytes
    while (true) {
      uint8_t b = byte();
      if (b != 0xFF) continue;
      uint8_t m = byte();
      while (m == 0xFF) m = byte();
      if (m != 0) return m;
    }
  }

  void handle_marker(int m) {
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      read_sof(m);
    } else if (m == 0xC3) {
      throw JpegError("lossless JPEG (SOF3) is not supported");
    } else if (m == 0xC5 || m == 0xC6 || m == 0xC7) {
      throw JpegError("hierarchical JPEG (SOF5-7) is not supported");
    } else if (m == 0xC9 || m == 0xCA || m == 0xCB || m == 0xCD ||
               m == 0xCE || m == 0xCF || m == 0xCC) {
      throw JpegError("arithmetic coding (SOF9-15 / DAC) is not supported");
    } else if (m == 0xC4) {
      read_dht();
    } else if (m == 0xDB) {
      read_dqt();
    } else if (m == 0xDD) {
      int len = u16();
      if (len != 4) throw JpegError("corrupt DRI segment");
      restart_interval_ = u16();
    } else if (m == 0xDC) {
      throw JpegError("the DNL marker is not supported");
    } else if (m == 0xE0 || m == 0xEE) {
      int len = u16();
      if (len < 2) throw JpegError("corrupt APP segment");
      int64_t start = pos_, end = pos_ + len - 2;
      if (end > n_) throw JpegError("image file is truncated");
      if (m == 0xE0 && len >= 7 &&
          std::memcmp(d_ + start, "JFIF\0", 5) == 0)
        jfif_ = true;
      if (m == 0xEE && len >= 14 &&
          std::memcmp(d_ + start, "Adobe", 5) == 0) {
        adobe_ = true;
        adobe_transform_ = d_[start + 11];
      }
      pos_ = end;
    } else if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) {
      // standalone markers: nothing to skip
    } else if (m == 0xD9) {
      throw JpegError("image file is truncated (EOI before the image)");
    } else {
      int len = u16();
      if (len < 2) throw JpegError("corrupt marker segment");
      pos_ += len - 2;
      if (pos_ > n_) throw JpegError("image file is truncated");
    }
  }

  void read_sof(int m) {
    if (frame_) throw JpegError("corrupt JPEG: two frames");
    int len = u16();
    int precision = byte();
    if (precision != 8)
      throw JpegError(std::to_string(precision) +
                      "-bit JPEG is not supported (8-bit only)");
    height = u16();
    width = u16();
    ncomp = byte();
    if (ncomp == 4)
      throw JpegError("CMYK / YCCK JPEG (4 components) is not supported");
    if (ncomp != 1 && ncomp != 3)
      throw JpegError(std::to_string(ncomp) +
                      "-component JPEG is not supported");
    if (len != 8 + 3 * ncomp) throw JpegError("corrupt SOF segment");
    if (height == 0) throw JpegError("the DNL marker is not supported");
    if (width == 0) throw JpegError("corrupt JPEG: zero width");
    comps_.resize(ncomp);
    for (auto& c : comps_) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw JpegError("corrupt SOF segment (sampling or table)");
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    progressive_ = (m == 0xC2);
    mcus_x_ = (width + 8 * max_h_ - 1) / (8 * max_h_);
    mcus_y_ = (height + 8 * max_v_ - 1) / (8 * max_v_);
    for (auto& c : comps_) {
      if (max_h_ % c.h || max_v_ % c.v)
        throw JpegError("non-integral sampling ratios are not supported");
      c.dw = (int)(((int64_t)width * c.h + max_h_ - 1) / max_h_);
      c.dh = (int)(((int64_t)height * c.v + max_v_ - 1) / max_v_);
      c.bw = mcus_x_ * c.h;
      c.bh = mcus_y_ * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    frame_ = true;
  }

  void read_dht() {
    int len = u16();
    int64_t end = pos_ + len - 2;
    while (pos_ < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) throw JpegError("corrupt DHT segment");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; i++) {
        counts[i] = byte();
        total += counts[i];
      }
      if (total > 256) throw JpegError("corrupt DHT segment");
      uint8_t vals[256];
      for (int i = 0; i < total; i++) vals[i] = byte();
      build_huffman(tc ? ac_[th] : dc_[th], counts, vals, total);
    }
    if (pos_ != end) throw JpegError("corrupt DHT segment length");
  }

  void read_dqt() {
    int len = u16();
    int64_t end = pos_ + len - 2;
    while (pos_ < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) throw JpegError("corrupt DQT segment");
      for (int k = 0; k < 64; k++)
        qtables_[tq][kNatural[k]] = (uint16_t)(pq ? u16() : byte());
      qdefined_[tq] = true;
    }
    if (pos_ != end) throw JpegError("corrupt DQT segment length");
  }

  bool scans_done_all() const {
    // a sequential file is whole once every component's blocks were
    // decoded; a single interleaved scan does this
    return sequential_components_done_ >= (int64_t)comps_.size();
  }

  // ---- bit reader --------------------------------------------------------
  void reset_bits() {
    acc_ = 0;
    nbits_ = 0;
    pad_bits_ = 0;
    at_marker_ = false;
    at_eof_ = false;
  }

  void fill() {
    while (nbits_ <= 56) {
      uint8_t b = 0;
      bool real = false;
      if (!at_marker_ && !at_eof_) {
        if (pos_ >= n_) {
          at_eof_ = true;
        } else if (d_[pos_] != 0xFF) {
          b = d_[pos_++];
          real = true;
        } else {
          int64_t q = pos_ + 1;
          while (q < n_ && d_[q] == 0xFF) q++;
          if (q >= n_) {
            at_eof_ = true;
          } else if (d_[q] == 0) {
            b = 0xFF;
            real = true;
            pos_ = q + 1;
          } else {
            at_marker_ = true;   // pos_ stays on the marker's first 0xFF
          }
        }
      }
      acc_ |= (uint64_t)b << (56 - nbits_);
      nbits_ += 8;
      if (!real) pad_bits_ += 8;
    }
  }

  // bits consumed past the data: zeros after a marker (libjpeg's
  // "insufficient data"), an error at the end of the file
  void check_overrun() {
    if (pad_bits_ > nbits_) {
      if (at_eof_) throw JpegError("image file is truncated");
      insufficient_ = true;
      pad_bits_ = nbits_;
    }
  }

  int get_bits(int n) {
    if (n == 0) return 0;
    if (nbits_ < n) fill();
    int v = (int)(acc_ >> (64 - n));
    acc_ <<= n;
    nbits_ -= n;
    check_overrun();
    return v;
  }

  int decode_huff(const Huffman& h) {
    if (nbits_ < 16) fill();
    int look = (int)(acc_ >> (64 - 9));
    int e = h.look[look];
    if (e) {
      int len = e >> 8;
      acc_ <<= len;
      nbits_ -= len;
      check_overrun();
      return e & 0xFF;
    }
    int code = (int)(acc_ >> (64 - 9));
    int len = 9;
    acc_ <<= 9;
    nbits_ -= 9;
    while (len < 17 && code > h.maxcode[len]) {
      if (nbits_ < 1) fill();
      code = (code << 1) | (int)(acc_ >> 63);
      acc_ <<= 1;
      nbits_ -= 1;
      len++;
    }
    check_overrun();
    if (len > 16) {
      // libjpeg warns (JWRN_HUFF_BAD_CODE) and returns 0
      return 0;
    }
    int idx = code + h.valoffset[len];
    if (idx < 0 || idx >= h.nvalues) return 0;
    return h.values[idx];
  }

  static int extend(int r, int s) {
    return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
  }

  // ---- scans ---------------------------------------------------------------
  void read_sos() {
    if (!frame_) throw JpegError("corrupt JPEG: scan before the frame");
    int len = u16();
    int ns = byte();
    if (ns < 1 || ns > 4 || len != 6 + 2 * ns)
      throw JpegError("corrupt SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int id = byte(), tables = byte();
      Component* c = nullptr;
      for (auto& cc : comps_)
        if (cc.id == id) c = &cc;
      if (c == nullptr) throw JpegError("corrupt SOS: unknown component");
      c->dc_tbl = tables >> 4;
      c->ac_tbl = tables & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3)
        throw JpegError("corrupt SOS segment (table index)");
      sc.push_back(c);
    }
    int ss = byte(), se = byte(), ahal = byte();
    int ah = ahal >> 4, al = ahal & 15;
    for (Component* c : sc) {
      if (!c->latched) {
        if (!qdefined_[c->tq])
          throw JpegError("corrupt JPEG: quantization table not defined");
        std::memcpy(c->qt, qtables_[c->tq], sizeof(c->qt));
        c->latched = true;
      }
    }
    if (progressive_) {
      if (ss == 0) {
        if (se != 0) throw JpegError("corrupt progressive scan (DC)");
      } else {
        if (ns != 1 || se < ss || se > 63)
          throw JpegError("corrupt progressive scan (AC)");
      }
      if (al > 13) throw JpegError("corrupt progressive scan (Al)");
      for (Component* c : sc)
        for (int k = ss; k <= se; k++) c->coef_bits[k] = al;
    } else {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        throw JpegError("corrupt sequential scan parameters");
    }
    for (Component* c : sc) {
      bool need_dc = !progressive_ || (ss == 0 && ah == 0);
      bool need_ac = !progressive_ || ss > 0;
      if ((need_dc && !dc_[c->dc_tbl].defined) ||
          (need_ac && !ac_[c->ac_tbl].defined))
        throw JpegError("corrupt JPEG: Huffman table not defined");
    }
    decode_scan(sc, ss, se, ah, al);
    if (!progressive_) sequential_components_done_ += ns;
  }

  void decode_scan(const std::vector<Component*>& sc, int ss, int se,
                   int ah, int al) {
    reset_bits();
    insufficient_ = false;
    int dc_pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int next_rst = 0;
    int64_t mcus, mcus_x;
    bool single = sc.size() == 1;
    if (single) {
      Component* c = sc[0];
      mcus_x = (c->dw + 7) / 8;
      mcus = mcus_x * (int64_t)((c->dh + 7) / 8);
    } else {
      mcus_x = mcus_x_;
      mcus = (int64_t)mcus_x_ * mcus_y_;
    }
    int64_t restart_left = restart_interval_;
    for (int64_t m = 0; m < mcus; m++) {
      if (restart_interval_ && restart_left == 0) {
        // discard the bits left of the interval; the RSTn marker follows
        acc_ = 0;
        nbits_ = 0;
        pad_bits_ = 0;
        at_marker_ = false;
        at_eof_ = false;
        while (true) {
          if (pos_ >= n_) throw JpegError("image file is truncated");
          if (d_[pos_] == 0xFF) break;
          pos_++;
        }
        int mk = next_marker();
        if (mk != 0xD0 + next_rst)
          throw JpegError("corrupt JPEG: unexpected restart marker");
        next_rst = (next_rst + 1) & 7;
        restart_left = restart_interval_;
        for (int& p : dc_pred) p = 0;
        eobrun = 0;
        insufficient_ = false;
      }
      if (restart_interval_) restart_left--;
      int64_t my = m / mcus_x, mx = m % mcus_x;
      for (size_t ci = 0; ci < sc.size(); ci++) {
        Component* c = sc[ci];
        int bh = single ? 1 : c->v, bw = single ? 1 : c->h;
        for (int by = 0; by < bh; by++) {
          for (int bx = 0; bx < bw; bx++) {
            int64_t row = single ? my : my * c->v + by;
            int64_t col = single ? mx : mx * c->h + bx;
            int16_t* blk = &c->coef[(size_t)((row * c->bw + col) * 64)];
            if (insufficient_) continue;
            if (!progressive_) {
              decode_block(blk, *c, dc_pred[ci]);
            } else if (ss == 0) {
              if (ah == 0) {
                int s = decode_huff(dc_[c->dc_tbl]);
                int r = s ? get_bits(s) : 0;
                int diff = s ? extend(r, s) : 0;
                dc_pred[ci] += diff;
                blk[0] = (int16_t)(dc_pred[ci] * (1 << al));
              } else if (get_bits(1)) {
                blk[0] = (int16_t)(blk[0] | (1 << al));
              }
            } else if (ah == 0) {
              ac_first(blk, ac_[c->ac_tbl], ss, se, al, eobrun);
            } else {
              ac_refine(blk, ac_[c->ac_tbl], ss, se, al, eobrun);
            }
          }
        }
      }
    }
    // leave pos_ on the marker that ends the scan
    if (!at_marker_) {
      while (pos_ < n_) {
        if (d_[pos_] == 0xFF && pos_ + 1 < n_ && d_[pos_ + 1] != 0 &&
            !(d_[pos_ + 1] >= 0xD0 && d_[pos_ + 1] <= 0xD7) &&
            d_[pos_ + 1] != 0xFF)
          break;
        pos_++;
      }
    }
  }

  void decode_block(int16_t* blk, const Component& c, int& pred) {
    int s = decode_huff(dc_[c.dc_tbl]);
    if (s) {
      int r = get_bits(s);
      s = extend(r, s);
    }
    pred += s;
    blk[0] = (int16_t)pred;
    const Huffman& ac = ac_[c.ac_tbl];
    for (int k = 1; k < 64; k++) {
      int rs = decode_huff(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        r = get_bits(s);
        blk[kNatural[k]] = (int16_t)extend(r, s);
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void ac_first(int16_t* blk, const Huffman& ac, int ss, int se, int al,
                int& eobrun) {
    if (eobrun > 0) {
      eobrun--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = decode_huff(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        r = get_bits(s);
        s = extend(r, s);
        blk[kNatural[k]] = (int16_t)(s * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += get_bits(r);
        eobrun--;
        break;
      }
    }
  }

  void ac_refine(int16_t* blk, const Huffman& ac, int ss, int se, int al,
                 int& eobrun) {
    int p1 = 1 << al, m1 = (-1) * (1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; k++) {
        int rs = decode_huff(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = get_bits(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += get_bits(r);
          break;
        }
        do {
          int16_t* t = blk + kNatural[k];
          if (*t != 0) {
            if (get_bits(1)) {
              if ((*t & p1) == 0) *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= se; k++) {
        int16_t* t = blk + kNatural[k];
        if (*t != 0 && get_bits(1)) {
          if ((*t & p1) == 0) *t = (int16_t)(*t >= 0 ? *t + p1 : *t + m1);
        }
      }
      eobrun--;
    }
  }

  // libjpeg-turbo smooths blocks (jdcoefct.c, decompress_smooth_data) when
  // a progressive file leaves one of the first nine AC positions unrefined
  void check_smoothing() {
    static const int kQ[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (auto& c : comps_) {
      if (!c.latched) return;
      for (int i = 0; i < 10; i++)
        if (c.qt[kQ[i]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      throw JpegError(
          "progressive JPEG whose scans leave coefficient bits unrefined "
          "(libjpeg block smoothing) is not supported");
  }

  // ---- islow IDCT (jidctint.c) ---------------------------------------------
  static inline uint8_t range_limit(int64_t x) {
    // IDCT_range_limit()[x & RANGE_MASK]: the 10-bit wrap, then clamp
    int v = (int)(x & 1023);
    if (v >= 512) v -= 1024;
    v += 128;
    return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
  }

  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995,
                  F3072 = 25172;
    const int CB = 13, P1 = 2;
    int ws[64];
    for (int c = 0; c < 8; c++) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* w = ws + c;
      if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
          ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
        int dc = (int)((int64_t)ip[0] * qp[0] * (1 << P1));
        for (int r = 0; r < 8; r++) w[8 * r] = dc;
        continue;
      }
      int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      z2 = (int64_t)ip[0] * qp[0];
      z3 = (int64_t)ip[32] * qp[32];
      int64_t tmp0 = (z2 + z3) * (1 << CB);
      int64_t tmp1 = (z2 - z3) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = (int64_t)ip[56] * qp[56];
      tmp1 = (int64_t)ip[40] * qp[40];
      tmp2 = (int64_t)ip[24] * qp[24];
      tmp3 = (int64_t)ip[8] * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB - P1;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      w[0] = (int)((tmp10 + tmp3 + rnd) >> sh);
      w[56] = (int)((tmp10 - tmp3 + rnd) >> sh);
      w[8] = (int)((tmp11 + tmp2 + rnd) >> sh);
      w[48] = (int)((tmp11 - tmp2 + rnd) >> sh);
      w[16] = (int)((tmp12 + tmp1 + rnd) >> sh);
      w[40] = (int)((tmp12 - tmp1 + rnd) >> sh);
      w[24] = (int)((tmp13 + tmp0 + rnd) >> sh);
      w[32] = (int)((tmp13 - tmp0 + rnd) >> sh);
    }
    for (int r = 0; r < 8; r++) {
      const int* w = ws + 8 * r;
      uint8_t* op = out + (size_t)r * stride;
      if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
          w[6] == 0 && w[7] == 0) {
        uint8_t dc = range_limit(((int64_t)w[0] + (1 << (P1 + 2))) >>
                                 (P1 + 3));
        for (int c = 0; c < 8; c++) op[c] = dc;
        continue;
      }
      int64_t z2 = w[2], z3 = w[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * (-F1847);
      int64_t tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CB);
      int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CB);
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
      int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      tmp0 = w[7];
      tmp1 = w[5];
      tmp2 = w[3];
      tmp3 = w[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3;
      int64_t z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = CB + P1 + 3;
      const int64_t rnd = (int64_t)1 << (sh - 1);
      op[0] = range_limit((tmp10 + tmp3 + rnd) >> sh);
      op[7] = range_limit((tmp10 - tmp3 + rnd) >> sh);
      op[1] = range_limit((tmp11 + tmp2 + rnd) >> sh);
      op[6] = range_limit((tmp11 - tmp2 + rnd) >> sh);
      op[2] = range_limit((tmp12 + tmp1 + rnd) >> sh);
      op[5] = range_limit((tmp12 - tmp1 + rnd) >> sh);
      op[3] = range_limit((tmp13 + tmp0 + rnd) >> sh);
      op[4] = range_limit((tmp13 - tmp0 + rnd) >> sh);
    }
  }

  // ---- upsampling (jdsample.c, fancy) and colour (jdcolor.c) ---------------
  // One component's samples at full resolution: (height, width).
  void upsample(const Component& c, const uint8_t* plane, int pstride,
                std::vector<uint8_t>& full) {
    const int hr = max_h_ / c.h, vr = max_v_ / c.v;
    const int dw = c.dw, dh = c.dh, W = width, H = height;
    full.resize((size_t)W * H);
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
      x = x < 0 ? 0 : (x >= dw ? dw - 1 : x);
      return plane[(size_t)y * pstride + x];
    };
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < H; y++)
        std::memcpy(&full[(size_t)y * W], plane + (size_t)y * pstride,
                    (size_t)W);
    } else if (hr == 2 && vr == 1 && dw > 2) {
      for (int y = 0; y < H; y++) {
        uint8_t* o = &full[(size_t)y * W];
        for (int x = 0; x < W; x++) {
          int sx = x >> 1;
          int near = at(y, sx) * 3;
          o[x] = (x & 1) ? (uint8_t)((near + at(y, sx + 1) + 2) >> 2)
                         : (uint8_t)((near + at(y, sx - 1) + 1) >> 2);
        }
      }
    } else if (hr == 1 && vr == 2) {
      for (int y = 0; y < H; y++) {
        uint8_t* o = &full[(size_t)y * W];
        int sy = y >> 1;
        bool below = y & 1;
        for (int x = 0; x < W; x++) {
          int s = at(sy, x) * 3 + at(below ? sy + 1 : sy - 1, x);
          o[x] = (uint8_t)((s + (below ? 2 : 1)) >> 2);
        }
      }
    } else if (hr == 2 && vr == 2 && dw > 2) {
      std::vector<int> cs((size_t)dw);
      for (int y = 0; y < H; y++) {
        int sy = y >> 1;
        int other = (y & 1) ? sy + 1 : sy - 1;
        for (int x = 0; x < dw; x++) cs[x] = at(sy, x) * 3 + at(other, x);
        uint8_t* o = &full[(size_t)y * W];
        for (int x = 0; x < W; x++) {
          int sx = x >> 1;
          int t = cs[sx] * 3;
          if (x & 1) {
            int nx = sx + 1 < dw ? sx + 1 : dw - 1;
            o[x] = (uint8_t)((t + cs[nx] + 7) >> 4);
          } else {
            int px = sx > 0 ? sx - 1 : 0;
            o[x] = (uint8_t)((t + cs[px] + 8) >> 4);
          }
        }
      }
    } else {
      // box replication (int_upsample, and h2v1 / h2v2 at dw <= 2)
      for (int y = 0; y < H; y++) {
        uint8_t* o = &full[(size_t)y * W];
        for (int x = 0; x < W; x++) o[x] = (uint8_t)at(y / vr, x / hr);
      }
    }
  }

  void output(uint8_t* out) {
    std::vector<std::vector<uint8_t>> full(comps_.size());
    for (size_t ci = 0; ci < comps_.size(); ci++) {
      Component& c = comps_[ci];
      if (!c.latched)
        throw JpegError("image file is truncated (a component has no scan)");
      int pstride = c.bw * 8;
      std::vector<uint8_t> plane((size_t)pstride * c.bh * 8);
      for (int by = 0; by < c.bh; by++)
        for (int bx = 0; bx < c.bw; bx++)
          idct_islow(&c.coef[(size_t)((by * c.bw + bx) * 64)], c.qt,
                     &plane[(size_t)by * 8 * pstride + bx * 8], pstride);
      upsample(c, plane.data(), pstride, full[ci]);
    }
    const size_t npix = (size_t)width * height;
    if (ncomp == 1) {
      std::memcpy(out, full[0].data(), npix);
      return;
    }
    bool rgb;
    if (jfif_) {
      rgb = false;
    } else if (adobe_) {
      rgb = adobe_transform_ == 0;
    } else {
      rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    }
    const uint8_t *y = full[0].data(), *cb = full[1].data(),
                  *cr = full[2].data();
    if (rgb) {
      for (size_t i = 0; i < npix; i++) {
        out[3 * i] = y[i];
        out[3 * i + 1] = cb[i];
        out[3 * i + 2] = cr[i];
      }
      return;
    }
    const int SB = 16;
    const int64_t HALF = (int64_t)1 << (SB - 1);
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; i++) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = (int)((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp = [](int v) -> uint8_t {
      return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (size_t i = 0; i < npix; i++) {
      int yy = y[i], b = cb[i], r = cr[i];
      out[3 * i] = clamp(yy + cr_r[r]);
      out[3 * i + 1] = clamp(yy + (int)((cb_g[b] + cr_g[r]) >> SB));
      out[3 * i + 2] = clamp(yy + cb_b[b]);
    }
  }
};

// ---------------------------------------------------------------------------
// TIFF LZW (libtiff's "new-style" codes: MSB first, early change)
// ---------------------------------------------------------------------------
struct LzwEntry {
  int32_t prefix;
  uint16_t length;
  uint8_t first, last;
};

}  // namespace

extern "C" {

// Undo PNG filtering: ``data`` holds ``rows`` scanlines of one filter byte
// and ``rowbytes`` bytes; ``out`` receives rows * rowbytes bytes.  ``bpp``
// is the filter's byte distance (bytes per complete pixel, at least 1).
// Returns 0, or -(row + 1) of the first scanline with an unknown filter.
int64_t sps_png_unfilter(const uint8_t* data, int64_t rows,
                         int64_t rowbytes, int bpp, uint8_t* out) {
  std::vector<uint8_t> zero((size_t)rowbytes, 0);
  for (int64_t r = 0; r < rows; r++) {
    const uint8_t* in = data + r * (rowbytes + 1);
    int f = in[0];
    in++;
    uint8_t* o = out + r * rowbytes;
    const uint8_t* up = r ? out + (r - 1) * rowbytes : zero.data();
    switch (f) {
      case 0:
        std::memcpy(o, in, (size_t)rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; i++)
          o[i] = (uint8_t)(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; i++) o[i] = (uint8_t)(in[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; i++)
          o[i] = (uint8_t)(in[i] + (((i >= bpp ? o[i - bpp] : 0) + up[i]) >> 1));
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? o[i - bpp] : 0;
          int c = i >= bpp ? up[i - bpp] : 0;
          o[i] = (uint8_t)(in[i] + paeth(a, up[i], c));
        }
        break;
      default:
        return -(r + 1);
    }
  }
  return 0;
}

// Read a JPEG's frame header: info = {width, height, components}.
int sps_jpeg_info(const uint8_t* data, int64_t len, int32_t* info, char* err,
                  int errlen) {
  try {
    Jpeg j(data, len);
    j.read_header();
    info[0] = j.width;
    info[1] = j.height;
    info[2] = j.ncomp;
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

// Decode a JPEG into ``out``: (height, width) for one component, else
// (height, width, 3) RGB.
int sps_jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out,
                    char* err, int errlen) {
  try {
    Jpeg j(data, len);
    j.read_header();
    j.decode(out);
    return 0;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return -1;
  }
}

// Decode one LZW-compressed TIFF strip into ``out`` (at most ``outlen``
// bytes).  Returns the bytes written, or -1 with ``err``.
int64_t sps_tiff_lzw(const uint8_t* in, int64_t inlen, uint8_t* out,
                     int64_t outlen, char* err, int errlen) {
  if (inlen >= 2 && in[0] == 0 && (in[1] & 1)) {
    set_err(err, errlen, "old-style (pre-6.0) TIFF LZW is not supported");
    return -1;
  }
  std::vector<LzwEntry> tab(4096);
  for (int i = 0; i < 256; i++) tab[i] = {-1, 1, (uint8_t)i, (uint8_t)i};
  int next = 258, nbits = 9;
  int64_t bitpos = 0, o = 0;
  const int64_t total = inlen * 8;
  int prev = -1;
  std::vector<uint8_t> stack;
  while (bitpos + nbits <= total) {
    int code = 0;
    for (int b = 0; b < nbits; b++, bitpos++)
      code = (code << 1) | ((in[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == 257) break;
    if (code == 256) {
      next = 258;
      nbits = 9;
      prev = -1;
      continue;
    }
    if (prev < 0) {
      if (code > 255) {
        set_err(err, errlen, "corrupt TIFF LZW strip");
        return -1;
      }
      if (o < outlen) out[o++] = (uint8_t)code;
      prev = code;
      continue;
    }
    int emit;
    uint8_t first;
    if (code < next) {
      emit = code;
      first = tab[code].first;
    } else if (code == next) {
      emit = -1;
      first = tab[prev].first;
    } else {
      set_err(err, errlen, "corrupt TIFF LZW strip (code out of range)");
      return -1;
    }
    if (next < 4096) {
      tab[next] = {prev, (uint16_t)(tab[prev].length + 1), tab[prev].first,
                   first};
      if (emit < 0) emit = next;
      next++;
    } else if (emit < 0) {
      set_err(err, errlen, "corrupt TIFF LZW strip (table full)");
      return -1;
    }
    // write the string of ``emit`` backwards
    int len = tab[emit].length;
    int64_t end = o + len;
    int64_t w = end - 1;
    for (int c = emit; c >= 0; c = tab[c].prefix, w--)
      if (w < outlen) out[w] = tab[c].last;
    o = end;
    prev = emit;
    if (next + 1 >= (1 << nbits) && nbits < 12) nbits++;
  }
  return std::min(o, outlen);
}

// Decode one PackBits-compressed TIFF strip.
int64_t sps_tiff_packbits(const uint8_t* in, int64_t inlen, uint8_t* out,
                          int64_t outlen, char* err, int errlen) {
  int64_t i = 0, o = 0;
  while (i < inlen && o < outlen) {
    int n = (int8_t)in[i++];
    if (n >= 0) {
      int64_t cnt = n + 1;
      if (i + cnt > inlen) {
        set_err(err, errlen, "corrupt TIFF PackBits strip");
        return -1;
      }
      cnt = std::min(cnt, outlen - o);
      std::memcpy(out + o, in + i, (size_t)cnt);
      i += n + 1;
      o += cnt;
    } else if (n != -128) {
      int64_t cnt = 1 - n;
      if (i >= inlen) {
        set_err(err, errlen, "corrupt TIFF PackBits strip");
        return -1;
      }
      cnt = std::min(cnt, outlen - o);
      std::memset(out + o, in[i++], (size_t)cnt);
      o += cnt;
    }
  }
  return o;
}

}  // extern "C"
