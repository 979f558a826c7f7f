"""The port's image decoders (``scaleprotoseg_torch.codecs``) against
Pillow, bit for bit, on files Pillow writes.

- PNG: every colour type and bit depth (gray 1/2/4/8/16, gray+alpha 8/16,
  RGB and RGBA 8/16, palette 1/2/4/8), Pillow's adaptive filters and each
  of the five filters forced, Adam7, sizes 1 x 1 and 37 x 53, a palette
  label;
- JPEG: quality 50 / 75 / 95 at 4:4:4, 4:2:2 and 4:2:0, a 4:4:0 (h1v2)
  file, gray, progressive, optimized Huffman tables, a restart interval,
  odd sizes, and a hypothesis search over small images, quality and
  subsampling;
- TIFF: multi-page, 8 / 16 / 32-bit gray and RGB, raw, PackBits, LZW and
  Deflate, with and without the predictor;
- ``to_rgb`` / ``to_l`` against ``convert("RGB")`` / ``convert("L")``;
- the refusals by name: a CMYK JPEG, an SOF9 (arithmetic) header, a
  truncated JPEG, a progressive JPEG that libjpeg would block-smooth and
  a tiled TIFF;
- the committed fixtures of ``tests/torch_fixtures/codecs``: PIL's decode
  of each file against its manifest, and the port's against PIL's.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from PIL import Image

from scaleprotoseg_torch import codecs

FIXTURES = os.path.join(os.path.dirname(__file__), "torch_fixtures",
                        "codecs")


def _image(h, w, c=3, seed=0):
    """A smooth gradient with noise: what a photograph gives a codec."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    base = np.stack([(x * 7 + y * 3) % 256, (x * 2 + y * 5) % 256,
                     (x * y) % 256, (x + 2 * y) % 256], -1)[..., :c]
    noise = rng.integers(-40, 40, base.shape)
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def _save(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def _assert_pil_equal(data: bytes):
    """The port's decode of ``data`` is PIL's: mode, dtype, shape and
    values, and both conversions."""
    pil = Image.open(io.BytesIO(data))
    ref = np.asarray(pil)
    mode, got, palette = codecs.decode(data)
    assert mode == pil.mode
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(codecs.to_rgb(mode, got, palette),
                                  np.asarray(pil.convert("RGB")))
    np.testing.assert_array_equal(codecs.to_l(mode, got, palette),
                                  np.asarray(pil.convert("L")))


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------
def _png(color, depth, h, w, interlace=0, filt=None, seed=0):
    """A PNG of ``color`` type at ``depth`` written by hand (Pillow writes
    neither 2/4-bit gray nor 16-bit colour), each scanline filtered with
    ``filt`` (0-4) or, when None, with row % 5.  ``chip_smoke.png_filtered``
    filters 8-bit gray and RGB the same way; this writer has its own copy
    because it also packs 1/2/4/16-bit samples, palettes and Adam7 passes
    and splits the data over two IDATs, and because these tests import
    neither torch nor the smoke script."""
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    rng = np.random.default_rng(seed)
    top = (1 << depth) - 1
    if color == 3:
        top = min(top, 5)
    samples = rng.integers(0, top + 1, (h, w, channels)).astype(np.uint32)

    def scanlines(a):
        ph, pw = a.shape[:2]
        if depth == 16:
            rows = a.astype(">u2").view(np.uint8).reshape(ph, -1)
        elif depth == 8:
            rows = a.astype(np.uint8).reshape(ph, -1)
        else:
            flat = a.reshape(ph, -1)
            per = 8 // depth
            pad = (-flat.shape[1]) % per
            flat = np.pad(flat, ((0, 0), (0, pad)))
            shifts = np.arange(per - 1, -1, -1) * depth
            rows = (flat.reshape(ph, -1, per) << shifts).sum(-1) \
                .astype(np.uint8)
        bpp = max(1, channels * depth // 8)
        out = []
        prev = np.zeros(rows.shape[1], np.int32)
        for r, row in enumerate(rows.astype(np.int32)):
            f = r % 5 if filt is None else filt
            left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
            upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
            if f == 0:
                enc = row
            elif f == 1:
                enc = row - left
            elif f == 2:
                enc = row - prev
            elif f == 3:
                enc = row - (left + prev) // 2
            else:
                p = left + prev - upleft
                pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prev, upleft))
                enc = row - pred
            out.append(bytes([f]) + (enc % 256).astype(np.uint8).tobytes())
            prev = row
        return b"".join(out)

    if interlace:
        raw = b""
        for x0, y0, dx, dy in codecs._ADAM7:
            sub = samples[y0::dy, x0::dx]
            if sub.size:
                raw += scanlines(sub)
    else:
        raw = scanlines(samples)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                      interlace))
    if color == 3:
        body += chunk(b"PLTE", bytes(range(3 * 6)))
    # the image data split over two IDAT chunks
    comp = zlib.compress(raw)
    body += chunk(b"IDAT", comp[:len(comp) // 2])
    body += chunk(b"IDAT", comp[len(comp) // 2:])
    return b"\x89PNG\r\n\x1a\n" + body + chunk(b"IEND", b"")


PNG_KINDS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16),
             (3, 1), (3, 2), (3, 4), (3, 8), (4, 8), (4, 16), (6, 8),
             (6, 16)]


@pytest.mark.parametrize("color,depth", PNG_KINDS)
def test_png_every_colour_type_and_depth(color, depth):
    for (h, w) in ((1, 1), (37, 53)):
        for interlace in (0, 1):
            _assert_pil_equal(_png(color, depth, h, w, interlace))
    for filt in range(5):
        _assert_pil_equal(_png(color, depth, 9, 13, filt=filt))


def test_png_written_by_pil():
    """Pillow's own files: adaptive filters (more than filter 0 used), the
    modes it writes, Adam7, a palette label, odd sizes."""
    a = _image(64, 96)
    data = _save(Image.fromarray(a), "PNG")
    rows = np.frombuffer(zlib.decompress(data[data.index(b"IDAT") + 4:
                                              data.index(b"IEND") - 8]),
                         np.uint8).reshape(64, -1)
    assert len(set(rows[:, 0].tolist())) > 1
    images = [Image.fromarray(a), Image.fromarray(a[..., 0]),
              Image.fromarray(np.dstack([a, a[..., :1]])),
              Image.fromarray(a[..., :2], "LA"),
              Image.fromarray(a[..., 0] > 128),
              Image.fromarray(a[..., 0].astype(np.uint16) * 257),
              Image.fromarray(a).quantize(37)]
    for im in images:
        for interlace in (False, True):
            _assert_pil_equal(_save(im, "PNG", interlace=interlace))
    for h, w in ((1, 1), (37, 53)):
        _assert_pil_equal(_save(Image.fromarray(_image(h, w)), "PNG"))
    # a palette label: class indices 0-20 and the 255 border, VOC's colours
    labels = np.random.default_rng(3).integers(0, 21, (37, 53))
    labels[::7] = 255
    lab = Image.fromarray(labels.astype(np.uint8), "P")
    pal = np.random.default_rng(4).integers(0, 256, (256, 3))
    lab.putpalette(pal.astype(np.uint8).tobytes())
    data = _save(lab, "PNG")
    _assert_pil_equal(data)
    mode, idx, palette = codecs.decode(data)
    assert mode == "P"
    np.testing.assert_array_equal(idx, labels)
    # convert("RGB")[:, :, 0] of a palette label is the palette's red, not
    # the class index: the JAX package's preprocessing reads this
    np.testing.assert_array_equal(codecs.to_rgb(mode, idx, palette)[..., 0],
                                  pal[labels, 0])


# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------
def _jpeg_440(h, w, quality=75, seed=0) -> bytes:
    """A 4:4:0 (h1v2) JPEG.  Pillow writes no 4:4:0, so a 4:2:2 file's
    frame header is rewritten: luma (2, 1) -> (1, 2) and the size set to
    one with the same count of MCUs (an MCU of 4:2:2 and of 4:4:0 holds
    the same blocks).  The decoded image is a rearranged one, and a valid
    file for both decoders."""
    w422, h422 = 16 * -(-w // 8), 8 * -(-h // 16)
    data = bytearray(_save(Image.fromarray(_image(h422, w422, seed=seed)),
                           "JPEG", quality=quality, subsampling=1))
    sof = data.index(b"\xff\xc0")
    assert -(-w422 // 16) == -(-w // 8) and -(-h422 // 8) == -(-h // 16)
    struct.pack_into(">HH", data, sof + 5, h, w)
    assert data[sof + 11] == 0x21
    data[sof + 11] = 0x12
    return bytes(data)


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_jpeg_qualities_and_subsampling(quality):
    for h, w in ((1, 1), (37, 53), (64, 96), (17, 8)):
        for subsampling in (0, 1, 2):
            _assert_pil_equal(_save(Image.fromarray(_image(h, w)), "JPEG",
                                    quality=quality,
                                    subsampling=subsampling))
        data = _jpeg_440(h, w, quality)
        assert Image.open(io.BytesIO(data)).layer[0][1:3] == (1, 2)
        _assert_pil_equal(data)


@pytest.mark.parametrize("kind", ["gray", "progressive", "optimize",
                                  "restart", "progressive_gray"])
def test_jpeg_coding_options(kind):
    for h, w in ((1, 1), (37, 53), (71, 130)):
        a = _image(h, w)
        im = Image.fromarray(a[..., 0] if "gray" in kind else a)
        kw = {"quality": 80}
        if "progressive" in kind:
            kw["progressive"] = True
        if kind == "optimize":
            kw["optimize"] = True
        if kind == "restart":
            kw["restart_marker_blocks"] = 3
        for subsampling in (0, 2):
            data = _save(im, "JPEG", subsampling=subsampling, **kw)
            if kind == "restart" and h > 8:
                assert b"\xff\xd0" in data and b"\xff\xdd" in data
            _assert_pil_equal(data)


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 48), w=st.integers(1, 48),
       quality=st.integers(1, 100), subsampling=st.sampled_from([0, 1, 2,
                                                                 "440"]),
       progressive=st.booleans(), seed=st.integers(0, 2 ** 16))
def test_jpeg_random_images(h, w, quality, subsampling, progressive, seed):
    """Random noise and gradients: an IDCT or upsampling off by one on a
    single pixel shows here."""
    if subsampling == "440":
        data = _jpeg_440(h, w, quality, seed)
    else:
        a = np.random.default_rng(seed).integers(0, 256, (h, w, 3),
                                                 dtype=np.uint8)
        if seed % 2:
            a = _image(h, w, seed=seed)
        data = _save(Image.fromarray(a), "JPEG", quality=quality,
                     subsampling=subsampling, progressive=progressive)
    _assert_pil_equal(data)


def test_jpeg_refusals_by_name(tmp_path):
    base = _save(Image.fromarray(_image(32, 32)), "JPEG", quality=75)
    cmyk = _save(Image.fromarray(_image(16, 16, 4), "CMYK"), "JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        codecs.decode(cmyk)
    sof9 = base.replace(b"\xff\xc0", b"\xff\xc9", 1)
    with pytest.raises(ValueError, match="arithmetic coding"):
        codecs.decode(sof9)
    sof3 = base.replace(b"\xff\xc0", b"\xff\xc3", 1)
    with pytest.raises(ValueError, match="lossless"):
        codecs.decode(sof3)
    i = base.index(b"\xff\xc0")
    twelve = base[:i + 4] + bytes([12]) + base[i + 5:]
    with pytest.raises(ValueError, match="12-bit"):
        codecs.decode(twelve)
    path = tmp_path / "cut.jpg"
    path.write_bytes(base[:len(base) * 2 // 3])
    with pytest.raises(OSError, match="truncated"):
        Image.open(path).load()
    with pytest.raises(ValueError, match="truncated") as err:
        codecs.read_image(str(path))
    assert "cut.jpg" in str(err.value)
    # a progressive file cut after its first scans, then closed with EOI:
    # libjpeg would block-smooth its unrefined coefficients
    prog = _save(Image.fromarray(_image(32, 32)), "JPEG", quality=75,
                 progressive=True)
    scans = [k for k in range(len(prog) - 1) if prog[k:k + 2] ==
             b"\xff\xda"]
    with pytest.raises(ValueError, match="block smoothing"):
        codecs.decode(prog[:scans[3]] + b"\xff\xd9")


# ---------------------------------------------------------------------------
# TIFF
# ---------------------------------------------------------------------------
TIFF_IMAGES = {
    "L": lambda a: Image.fromarray(a[..., 0]),
    "RGB": lambda a: Image.fromarray(a),
    "I;16": lambda a: Image.fromarray(a[..., 0].astype(np.uint16) * 251),
    "I": lambda a: Image.fromarray(a[..., 0].astype(np.int32) * 39_000),
}


@pytest.mark.parametrize("compression", [None, "packbits", "tiff_lzw",
                                         "tiff_adobe_deflate"])
def test_tiff_modes_and_compressions(compression):
    for mode, make in TIFF_IMAGES.items():
        for h, w in ((1, 1), (37, 53), (64, 96)):
            im = make(_image(h, w))
            kw = {} if compression is None else {"compression": compression}
            predictors = (1, 2) if compression in ("tiff_lzw",
                                                   "tiff_adobe_deflate") \
                else (1,)
            for predictor in predictors:
                if predictor == 2:
                    kw["tiffinfo"] = {317: 2}
                data = _save(im, "TIFF", **kw)
                # the file holds the predictor asked for, so predictor 2's
                # undoing is what the decode below checks
                assert codecs.TiffFile("<bytes>", data).ifds[0].get(
                    317, (1,)) == (predictor,)
                assert Image.open(io.BytesIO(data)).tag_v2.get(
                    317, 1) == predictor
                _assert_pil_equal(data)


def test_tiff_pages(tmp_path):
    """A 5-page stack, as the ISBI volume holds its frames: ``n_frames``
    and every page equal to PIL's ``seek``."""
    frames = [Image.fromarray(_image(40, 56, seed=s)[..., 0])
              for s in range(5)]
    for compression in (None, "tiff_lzw"):
        path = tmp_path / f"stack_{compression}.tif"
        kw = {} if compression is None else {"compression": compression}
        frames[0].save(path, save_all=True, append_images=frames[1:], **kw)
        pil = Image.open(path)
        tif = codecs.TiffFile(str(path))
        assert tif.n_frames == pil.n_frames == 5
        for i in (3, 0, 4):
            pil.seek(i)
            mode, a, _ = tif.page(i)
            assert mode == pil.mode
            np.testing.assert_array_equal(a, np.asarray(pil))
            np.testing.assert_array_equal(codecs.to_rgb(mode, a),
                                          np.asarray(pil.convert("RGB")))
        assert len(list(tif)) == 5
        with pytest.raises(EOFError):
            tif.page(5)


def _tiled_tiff() -> bytes:
    """A little-endian 16 x 16 8-bit gray TIFF stored in one 16 x 16
    tile."""
    entries = [(256, 3, 1, 16), (257, 3, 1, 16), (258, 3, 1, 8),
               (259, 3, 1, 1), (262, 3, 1, 1), (277, 3, 1, 1),
               (322, 3, 1, 16), (323, 3, 1, 16), (324, 4, 1, 8 + 2 + 12 * 10
                                                  + 4),
               (325, 4, 1, 256)]
    ifd = struct.pack("<H", len(entries))
    for tag, typ, count, value in entries:
        fmt = "<HHIHH" if typ == 3 else "<HHII"
        ifd += struct.pack(fmt, tag, typ, count, value, *((0,) if typ == 3
                                                          else ()))
    ifd += struct.pack("<I", 0)
    return b"II*\x00" + struct.pack("<I", 8) + ifd + bytes(range(256))


def test_tiff_refusals_by_name():
    data = _tiled_tiff()
    assert Image.open(io.BytesIO(data)).size == (16, 16)
    with pytest.raises(ValueError, match="tiled TIFF"):
        codecs.decode(data)
    floats = _save(Image.fromarray(np.zeros((4, 4), np.float32)), "TIFF")
    with pytest.raises(ValueError, match="floating-point"):
        codecs.decode(floats)


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------
def test_fixtures_match_their_manifest():
    """PIL's decode of every fixture matches the manifest's SHA-256, dtype
    and shape (so the files cannot drift from what chip_smoke.py checks
    on the GPU machine), and the port's decode is PIL's."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    names = sorted(n for n in os.listdir(FIXTURES) if n != "manifest.json")
    assert sorted(manifest) == names
    total = 0
    for name, want in manifest.items():
        path = os.path.join(FIXTURES, name)
        total += os.path.getsize(path)
        pil = Image.open(path)
        ref = np.asarray(pil)
        assert (pil.mode, str(ref.dtype), list(ref.shape)) == (
            want["mode"], want["dtype"], want["shape"])
        assert hashlib.sha256(ref.tobytes()).hexdigest() == want["sha256"]
        mode, got, _ = codecs.read_image(path)
        assert mode == pil.mode
        np.testing.assert_array_equal(got, ref)
    assert total <= 300_000


def test_failed_build_raises(tmp_path, monkeypatch):
    from scaleprotoseg_torch import native
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(native, "COMPILER", "/nonexistent/bin/g++")
    monkeypatch.setattr(codecs, "_lib", None)
    with pytest.raises(RuntimeError, match="codecs.cc: cannot build"):
        codecs.decode(_save(Image.fromarray(_image(8, 8)), "JPEG"))
