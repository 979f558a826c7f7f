"""PNG, JPEG and TIFF decoding without PIL, bit-equal to Pillow 12.

The GPU machine has no PIL, yet every dataset ships its images and labels
as PNG, JPEG or TIFF.  This module returns what Pillow returns:

- ``read_image(path)`` -> ``(mode, array, palette)``: ``mode`` is
  ``Image.open(path).mode``, ``array`` is ``np.asarray(Image.open(path))``
  and ``palette`` is the (256, 3) uint8 palette of a ``P`` image (zeros
  past the file's entries, as Pillow pads it), else None;
- ``to_rgb(mode, array, palette)`` and ``to_l(...)``: the arrays of
  ``.convert("RGB")`` and ``.convert("L")`` (``L`` from colour is
  ``(R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16``, Pillow's
  ``L24``; a palette image converts through its palette);
- ``read_rgb(path)`` / ``read_l(path)``: both steps at once;
- ``TiffFile(path)``: ``n_frames`` and ``page(i)``, as ``Image.seek(i)``;
- ``encode_png`` / ``write_png`` / ``save_gray``: the writer of every PNG
  the port makes (8-bit gray, RGB or RGBA, each scanline behind filter
  byte 0; decoded pixels match what PIL or matplotlib would write, the
  bytes do not).

Modes, by format:

- PNG: every bit depth and colour type of the standard, Adam7 included.
  1-bit gray is ``1`` (bool); 2- and 4-bit gray are ``L`` scaled to
  0-255; 16-bit gray is ``I;16``; 16-bit RGB and RGBA keep their high
  bytes; 16-bit gray+alpha is ``RGBA``; palette files are ``P`` with
  their indices.
- JPEG: baseline and progressive Huffman, 8-bit, 1 (``L``) or 3
  (``RGB``) components, any sampling up to 2 x 2 (other integral ratios
  replicate), restart intervals, decoded as libjpeg-turbo 3.1 does by
  default (islow IDCT, fancy upsampling).  The EXIF orientation is not
  applied (``Image.open`` does not apply it).
- TIFF: strips, uncompressed, PackBits, LZW or Deflate, predictor 1 or
  2; 8-bit gray (``L``), 16-bit (``I;16``, ``I;16B`` big-endian) and
  32-bit (``I``) gray, 8-bit RGB.

Anything else raises ``ValueError`` naming the file and the feature:
arithmetic coding, 12-bit, lossless and hierarchical JPEG, CMYK / YCCK,
a progressive JPEG that libjpeg would block-smooth, tiled, JPEG-in-TIFF,
floating-point or planar TIFF.  A truncated file raises, as Pillow does
by default.

The pixel work (PNG unfiltering, the JPEG decoder, TIFF's LZW and
PackBits) is ``native/codecs.cc``, built with g++ at first use; ctypes
releases the GIL for each call.  A failed build raises; nothing falls
back to PIL or numpy.  zlib streams are inflated by Python's ``zlib``.
The module imports neither torch nor PIL, so the preprocessing workers
start quickly.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from scaleprotoseg_torch import native

SOURCE = Path(native.__file__).resolve().parent / "codecs.cc"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_u8 = ctypes.POINTER(ctypes.c_uint8)
_ERRLEN = 512

Decoded = Tuple[str, np.ndarray, Optional[np.ndarray]]


def load_library() -> ctypes.CDLL:
    """The decoders' library, built on first use (raises if it cannot
    be)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build(SOURCE)))
            lib.sps_png_unfilter.argtypes = [_u8, ctypes.c_int64,
                                             ctypes.c_int64, ctypes.c_int,
                                             _u8]
            lib.sps_png_unfilter.restype = ctypes.c_int64
            lib.sps_jpeg_info.argtypes = [
                _u8, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_char_p, ctypes.c_int]
            lib.sps_jpeg_info.restype = ctypes.c_int
            lib.sps_jpeg_decode.argtypes = [_u8, ctypes.c_int64, _u8,
                                            ctypes.c_char_p, ctypes.c_int]
            lib.sps_jpeg_decode.restype = ctypes.c_int
            for fn in (lib.sps_tiff_lzw, lib.sps_tiff_packbits):
                fn.argtypes = [_u8, ctypes.c_int64, _u8, ctypes.c_int64,
                               ctypes.c_char_p, ctypes.c_int]
                fn.restype = ctypes.c_int64
            _lib = lib
        return _lib


def _ptr(buf: np.ndarray):
    return buf.ctypes.data_as(_u8)


def _bytes(data: bytes) -> np.ndarray:
    return np.frombuffer(data, np.uint8)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _unfilter(data: np.ndarray, rows: int, rowbytes: int, bpp: int,
              where: str) -> np.ndarray:
    out = np.empty((rows, rowbytes), np.uint8)
    if rows == 0 or rowbytes == 0:
        return out
    res = load_library().sps_png_unfilter(_ptr(data), rows, rowbytes, bpp,
                                          _ptr(out))
    if res < 0:
        raise ValueError(f"{where}: unknown PNG filter type in scanline "
                         f"{-res - 1}")
    return out


def _unpack(rows: np.ndarray, width: int, depth: int,
            channels: int) -> np.ndarray:
    """(h, rowbytes) scanline bytes -> (h, width, channels) samples
    (uint8 below 16 bits, native uint16 at 16)."""
    h = rows.shape[0]
    n = width * channels
    if depth == 8:
        return rows[:, :n].reshape(h, width, channels)
    if depth == 16:
        return rows[:, :2 * n].copy().view(">u2").astype(np.uint16) \
            .reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits * weights).sum(axis=2, dtype=np.uint8)
    return vals[:, :n].reshape(h, width, channels)


def _decode_png(data: bytes, where: str) -> Decoded:
    pos, idat, header, plte = 8, [], None, None
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{where}: PNG file is truncated")
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) < n or len(crc) < 4:
            raise ValueError(f"{where}: PNG file is truncated")
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I",
                                                                 crc)[0]:
            raise ValueError(f"{where}: broken PNG file (CRC of "
                             f"{kind.decode('latin-1')})")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{where}: PNG without IHDR")
    w, h, depth, color, compression, filt, interlace = header
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color]:
        raise ValueError(f"{where}: PNG colour type {color} at bit depth "
                         f"{depth} is not valid")
    if compression or filt or interlace > 1:
        raise ValueError(f"{where}: PNG compression {compression}, filter "
                         f"method {filt}, interlace {interlace} not known")
    if color == 3 and plte is None:
        raise ValueError(f"{where}: palette PNG without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{where}: PNG image data is truncated or "
                         f"corrupt ({e})") from e
    c = _PNG_CHANNELS[color]
    bpp = max(1, c * depth // 8)

    def rowbytes(width):
        return (width * c * depth + 7) // 8

    buf = _bytes(raw)
    if not interlace:
        need = h * (1 + rowbytes(w))
        if len(buf) < need:
            raise ValueError(f"{where}: PNG image data is truncated")
        samples = _unpack(_unfilter(buf, h, rowbytes(w), bpp, where), w,
                          depth, c)
    else:
        samples = np.zeros((h, w, c), np.uint16 if depth == 16 else
                           np.uint8)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            need = ph * (1 + rowbytes(pw))
            if off + need > len(buf):
                raise ValueError(f"{where}: PNG image data is truncated")
            rows = _unfilter(buf[off:off + need], ph, rowbytes(pw), bpp,
                             where)
            samples[y0::dy, x0::dx] = _unpack(rows, pw, depth, c)
            off += need
    palette = None
    if color == 0:
        a = samples[..., 0]
        if depth == 1:
            return "1", a != 0, None
        if depth == 16:
            return "I;16", a.astype("<u2"), None
        return "L", a * np.uint8(255 // ((1 << depth) - 1)), None
    if color == 3:
        pal = _bytes(plte)[:len(plte) // 3 * 3].reshape(-1, 3)[:256]
        palette = np.zeros((256, 3), np.uint8)
        palette[:len(pal)] = pal
        return "P", np.ascontiguousarray(samples[..., 0]), palette
    if depth == 16:
        samples = (samples >> 8).astype(np.uint8)
    if color == 2:
        return "RGB", np.ascontiguousarray(samples), None
    if color == 6:
        return "RGBA", np.ascontiguousarray(samples), None
    if depth == 16:  # 16-bit gray + alpha opens as RGBA
        g = samples[..., 0]
        return "RGBA", np.stack([g, g, g, samples[..., 1]], -1), None
    return "LA", np.ascontiguousarray(samples), None


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------
def _decode_jpeg(data: bytes, where: str) -> Decoded:
    lib = load_library()
    buf = _bytes(data)
    info = (ctypes.c_int32 * 3)()
    err = ctypes.create_string_buffer(_ERRLEN)
    if lib.sps_jpeg_info(_ptr(buf), len(buf), info, err, _ERRLEN):
        raise ValueError(f"{where}: {err.value.decode()}")
    w, h, c = info
    out = np.empty((h, w) if c == 1 else (h, w, 3), np.uint8)
    if lib.sps_jpeg_decode(_ptr(buf), len(buf), _ptr(out), err, _ERRLEN):
        raise ValueError(f"{where}: {err.value.decode()}")
    return ("L" if c == 1 else "RGB"), out, None


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------
_TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 6: "b", 7: "B", 8: "h",
               9: "i", 16: "Q"}
_TIFF_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 6: 1, 7: 1, 8: 2, 9: 4, 16: 8}
_TILE_TAGS = (322, 323, 324, 325)


class TiffFile:
    """A TIFF's pages: ``n_frames`` and ``page(i)`` -> ``(mode, array,
    None)``, as ``Image.seek(i)`` then ``np.asarray``."""

    def __init__(self, path: str, data: Optional[bytes] = None):
        self.path = str(path)
        if data is None:
            with open(path, "rb") as f:
                data = f.read()
        self.data = data
        order = data[:2]
        if order not in (b"II", b"MM"):
            raise ValueError(f"{self.path}: not a TIFF file")
        self.e = "<" if order == b"II" else ">"
        magic, = struct.unpack(self.e + "H", data[2:4])
        if magic == 43:
            raise ValueError(f"{self.path}: BigTIFF is not supported")
        if magic != 42:
            raise ValueError(f"{self.path}: not a TIFF file")
        self.ifds: List[dict] = []
        off, = struct.unpack(self.e + "I", data[4:8])
        seen = set()
        while off and off not in seen:
            seen.add(off)
            tags, off = self._ifd(off)
            self.ifds.append(tags)

    @property
    def n_frames(self) -> int:
        return len(self.ifds)

    def _ifd(self, off: int):
        d, e = self.data, self.e
        if off + 2 > len(d):
            raise ValueError(f"{self.path}: TIFF file is truncated")
        n, = struct.unpack(e + "H", d[off:off + 2])
        tags = {}
        for i in range(n):
            p = off + 2 + 12 * i
            if p + 12 > len(d):
                raise ValueError(f"{self.path}: TIFF file is truncated")
            tag, typ, count = struct.unpack(e + "HHI", d[p:p + 8])
            if typ not in _TIFF_TYPES:
                continue
            size = _TIFF_SIZES[typ] * count
            vp = p + 8 if size <= 4 else struct.unpack(e + "I",
                                                       d[p + 8:p + 12])[0]
            raw = d[vp:vp + size]
            if len(raw) < size:
                raise ValueError(f"{self.path}: TIFF file is truncated")
            if typ == 2:
                tags[tag] = raw
            else:
                tags[tag] = struct.unpack(e + _TIFF_TYPES[typ] * count, raw)
        p = off + 2 + 12 * n
        nxt, = struct.unpack(e + "I", d[p:p + 4]) if p + 4 <= len(d) \
            else (0,)
        return tags, nxt

    def __iter__(self) -> Iterator[Decoded]:
        return (self.page(i) for i in range(self.n_frames))

    def page(self, i: int) -> Decoded:
        where = f"{self.path} (page {i})"
        if not 0 <= i < self.n_frames:
            raise EOFError(f"{where}: no such page of {self.n_frames}")
        t = self.ifds[i]

        def one(tag, default=None):
            v = t.get(tag)
            return default if v is None else v[0]

        if any(tag in t for tag in _TILE_TAGS):
            raise ValueError(f"{where}: tiled TIFF is not supported")
        w, h = one(256), one(257)
        if w is None or h is None:
            raise ValueError(f"{where}: TIFF page without its size")
        spp = one(277, 1)
        bits = t.get(258, (1,) * spp)
        compression, photometric = one(259, 1), one(262)
        predictor, planar = one(317, 1), one(284, 1)
        fmt = t.get(339, (1,) * spp)[0]
        if planar != 1 and spp > 1:
            raise ValueError(f"{where}: planar configuration {planar} "
                             "is not supported")
        if one(266, 1) != 1:
            raise ValueError(f"{where}: TIFF fill order 2 is not supported")
        if len(set(bits)) != 1 or len(bits) != spp:
            raise ValueError(f"{where}: TIFF bits per sample {bits}")
        depth = bits[0]
        if fmt == 3:
            raise ValueError(f"{where}: floating-point TIFF samples are "
                             "not supported")
        if fmt not in (1, 2):
            raise ValueError(f"{where}: TIFF sample format {fmt}")
        if spp == 1 and photometric in (0, 1) and depth in (8, 16, 32):
            if photometric == 0 and depth != 8:
                raise ValueError(f"{where}: {depth}-bit min-is-white TIFF "
                                 "is not supported")
        elif not (spp == 3 and photometric == 2 and depth == 8):
            raise ValueError(
                f"{where}: TIFF of {spp} sample(s) at {depth} bits, "
                f"photometric {photometric}, is not supported (8/16/32-bit "
                "gray and 8-bit RGB only)")
        if compression in (6, 7):
            raise ValueError(f"{where}: JPEG-in-TIFF is not supported")
        if compression not in (1, 5, 8, 32946, 32773):
            raise ValueError(f"{where}: TIFF compression {compression} is "
                             "not supported")
        if predictor not in (1, 2):
            raise ValueError(f"{where}: TIFF predictor {predictor} is not "
                             "supported")
        offsets = t.get(273)
        if offsets is None:
            raise ValueError(f"{where}: TIFF page without strips")
        nbytes = depth // 8
        rowbytes = w * spp * nbytes
        rps = min(one(278, h), h) or h
        counts = t.get(279)
        if counts is None:
            if compression != 1:
                raise ValueError(f"{where}: TIFF strips without byte counts")
            counts = [min(rps, h - k * rps) * rowbytes
                      for k in range(len(offsets))]
        out = np.zeros(h * rowbytes, np.uint8)
        lib = load_library()
        err = ctypes.create_string_buffer(_ERRLEN)
        for k, (off, cnt) in enumerate(zip(offsets, counts)):
            rows = min(rps, h - k * rps)
            if rows <= 0:
                break
            want = rows * rowbytes
            raw = self.data[off:off + cnt]
            if len(raw) < cnt:
                raise ValueError(f"{where}: TIFF file is truncated")
            if compression == 1:
                strip = _bytes(raw)[:want]
            elif compression in (8, 32946):
                try:
                    strip = _bytes(zlib.decompressobj().decompress(raw,
                                                                  want))
                except zlib.error as e:
                    raise ValueError(f"{where}: corrupt Deflate strip "
                                     f"({e})") from e
            else:
                fn = lib.sps_tiff_lzw if compression == 5 \
                    else lib.sps_tiff_packbits
                src = _bytes(raw)
                strip = np.zeros(want, np.uint8)
                got = fn(_ptr(src), len(src), _ptr(strip), want, err,
                         _ERRLEN)
                if got < 0:
                    raise ValueError(f"{where}: {err.value.decode()}")
                strip = strip[:got]
            if len(strip) < want:
                raise ValueError(f"{where}: TIFF strip {k} is truncated")
            base = k * rps * rowbytes
            out[base:base + want] = strip
        kind = "i" if fmt == 2 else "u"
        dt = np.dtype(f"{kind}{nbytes}")
        a = out.view(dt.newbyteorder(self.e)).reshape(h, w, spp).astype(dt)
        if predictor == 2:
            a = np.cumsum(a, axis=1, dtype=dt)
        if spp == 3:
            return "RGB", np.ascontiguousarray(a), None
        a = a[..., 0]
        if depth == 8:
            a = a.astype(np.uint8)
            return "L", (255 - a if photometric == 0 else a), None
        if depth == 16 and fmt == 1:
            if self.e == "<":
                return "I;16", a.astype("<u2"), None
            return "I;16B", a.astype(">u2"), None
        return "I", a.astype(np.int32), None


# ---------------------------------------------------------------------------
# the API
# ---------------------------------------------------------------------------
def decode(data: bytes, where: str = "<bytes>") -> Decoded:
    """``(mode, array, palette)`` of an encoded image (a TIFF's first
    page)."""
    if data[:8] == _PNG_SIGNATURE:
        return _decode_png(data, where)
    if data[:2] == b"\xff\xd8":
        return _decode_jpeg(data, where)
    if data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return TiffFile(where, data).page(0)
    raise ValueError(f"{where}: not a PNG, JPEG or TIFF file")


def read_image(path: str) -> Decoded:
    """``(Image.open(path).mode, np.asarray(Image.open(path)), palette)``."""
    with open(path, "rb") as f:
        return decode(f.read(), str(path))


def _weights_l(rgb: np.ndarray) -> np.ndarray:
    x = rgb.astype(np.uint32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471 +
             0x8000) >> 16).astype(np.uint8)


def _clip8(a: np.ndarray) -> np.ndarray:
    return np.clip(a.astype(np.int64), 0, 255).astype(np.uint8)


def to_l(mode: str, array: np.ndarray,
         palette: Optional[np.ndarray] = None) -> np.ndarray:
    """``.convert("L")``: uint8 (H, W)."""
    if mode == "L":
        return array
    if mode == "1":
        return np.where(array, np.uint8(255), np.uint8(0))
    if mode == "LA":
        return np.ascontiguousarray(array[..., 0])
    if mode in ("I;16", "I;16B", "I"):
        return _clip8(array)
    if mode in ("RGB", "RGBA"):
        return _weights_l(array[..., :3])
    if mode == "P":
        return _weights_l(palette)[array]
    raise ValueError(f"cannot convert mode {mode!r} to L")


def to_rgb(mode: str, array: np.ndarray,
           palette: Optional[np.ndarray] = None) -> np.ndarray:
    """``.convert("RGB")``: uint8 (H, W, 3)."""
    if mode == "RGB":
        return array
    if mode == "RGBA":
        return np.ascontiguousarray(array[..., :3])
    if mode == "P":
        return palette[array]
    if mode in ("L", "1", "LA", "I;16", "I;16B", "I"):
        return np.repeat(to_l(mode, array)[..., None], 3, axis=2)
    raise ValueError(f"cannot convert mode {mode!r} to RGB")


def read_rgb(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("RGB"))``."""
    return to_rgb(*read_image(path))


def read_l(path: str) -> np.ndarray:
    """``np.asarray(Image.open(path).convert("L"))``."""
    return to_l(*read_image(path))


# ---------------------------------------------------------------------------
# the PNG writer
# ---------------------------------------------------------------------------
# zlib level of every PNG written here; decoded pixels do not depend on it.
# Level 0 stores the scanlines uncompressed, 6 is PIL's default; 1 is the
# cheapest level that compresses.  chip_smoke.zlib_levels prints the seconds
# and sizes of all three on a run's own push artifacts.
ZLIB_LEVEL = 1

_COLOR_TYPE = {1: 0, 3: 2, 4: 6}          # channels -> PNG colour type


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray, level: int = ZLIB_LEVEL,
               text: Optional[Dict[str, str]] = None) -> bytes:
    """PNG bytes of a uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA
    array; every scanline behind filter byte 0; ``text``: a ``tEXt`` chunk
    per keyword (Latin-1)."""
    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8 pixels, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE or 0 in a.shape[:2]:
        raise ValueError(f"encode_png: unsupported shape {pixels.shape}")
    h, w, c = a.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)
    rows[:, 1:] = a.reshape(h, w * c)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_PNG_SIGNATURE + _chunk(b"IHDR", header) +
            _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) +
            b"".join(_chunk(b"tEXt", k.encode("latin-1") + b"\0" +
                            v.encode("latin-1", "replace"))
                     for k, v in (text or {}).items()) +
            _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray,
              text: Optional[Dict[str, str]] = None) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels, text=text))


def save_gray(path: str, labels: np.ndarray) -> None:
    """``Image.fromarray(labels).convert("L").save(path)`` of uint8
    (H, W) labels."""
    write_png(path, np.asarray(labels, np.uint8))
