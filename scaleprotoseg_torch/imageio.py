"""PNG images without PIL, cv2 or matplotlib.

The GPU machine has none of the three, yet the push artifacts, the
nearest-patch artifacts and the test-split export write PNGs.  This module
writes them with the standard library (``zlib`` + ``struct``), each
scanline built in numpy behind filter byte 0, and decodes such files back.
It reproduces the pixels of the JAX package's renderers:

- ``imsave_rgb``: ``matplotlib.pyplot.imsave`` of a float (H, W, 3) image
  in [0, 1] is an RGBA PNG whose channels are ``(x * 255).astype(uint8)``
  (truncation, not rounding) and whose alpha is 255;
- ``save_gray``: ``PIL.Image.fromarray(a).convert("L").save`` of a uint8
  (H, W) array is an 8-bit gray PNG of the same values;
- ``jet``: ``matplotlib.pyplot.cm.jet(x)`` of floats in [0, 1]: the
  256-entry table built from matplotlib's ``_jet_data`` segments as
  ``LinearSegmentedColormap`` builds it, indexed at ``int(x * 256)``
  (1.0 maps to 255, NaN to the transparent "bad" colour);
- ``tab20``: ``matplotlib.cm.tab20(x)``, the 20-colour listed table
  indexed the same way at ``int(x * 20)``; ``tab20_bytes`` of labels is
  ``cm.tab20(Normalize(vmin, vmax)(labels), bytes=True)`` with the
  panel's own minimum and maximum, the colouring of eval's sample renders.

Decoded pixels are what match, not file bytes: matplotlib adds a
``Software`` text chunk and PIL picks its own filters and zlib level.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

# zlib level of every PNG written here; decoded pixels do not depend on it.
# Level 0 stores the scanlines uncompressed, 6 is PIL's default; 1 is the
# cheapest level that compresses.  chip_smoke.zlib_levels prints the seconds
# and sizes of all three on a run's own push artifacts.
ZLIB_LEVEL = 1

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}          # channels -> PNG colour type
_CHANNELS = {v: k for k, v in _COLOR_TYPE.items()}

# matplotlib's ``_cm._jet_data``: (x, y0, y1) segments per channel
_JET_DATA = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}
_JET_N = 256

# matplotlib's ``_cm._tab20_data``, as the hex colours it lists
_TAB20_HEX = ("1f77b4", "aec7e8", "ff7f0e", "ffbb78", "2ca02c", "98df8a",
              "d62728", "ff9896", "9467bd", "c5b0d5", "8c564b", "c49c94",
              "e377c2", "f7b6d2", "7f7f7f", "c7c7c7", "bcbd22", "dbdb8d",
              "17becf", "9edae5")


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(pixels: np.ndarray, level: int = ZLIB_LEVEL) -> bytes:
    """PNG bytes of a uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA
    array; every scanline behind filter byte 0."""
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
    return (_SIGNATURE + _chunk(b"IHDR", header) +
            _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) +
            _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels))


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG whose scanlines all use filter
    0 (what ``encode_png`` writes): (H, W) for gray, else (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        pos += 12 + n
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB/RGBA")
    c = _CHANNELS[color]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8) \
        .reshape(h, 1 + w * c)
    if rows[:, 0].any():
        raise ValueError(f"{path}: a scanline uses a filter other than 0")
    out = rows[:, 1:].reshape(h, w, c)
    return out[..., 0] if c == 1 else out


def rgba_bytes(image: torch.Tensor) -> np.ndarray:
    """What ``plt.imsave`` stores for a float (H, W, 3) image in [0, 1]:
    uint8 RGBA, the colours truncated from ``x * 255`` in the image's own
    dtype and alpha 255.  Runs on the image's device; returns host
    pixels."""
    x = torch.as_tensor(image)
    if x.ndim != 3 or x.shape[2] != 3 or not x.dtype.is_floating_point:
        raise ValueError("rgba_bytes takes a float (H, W, 3) image")
    if x.numel() and (bool(x.max() > 1) or bool(x.min() < 0)):
        raise ValueError("float RGB values must lie in [0, 1]")
    out = torch.ones(x.shape[:2] + (4,), dtype=x.dtype, device=x.device)
    out[..., :3] = x
    return (out * 255).to(torch.uint8).cpu().numpy()


def imsave_rgb(path: str, image: torch.Tensor) -> None:
    """``plt.imsave(path, image)`` of a float RGB image in [0, 1]."""
    write_png(path, rgba_bytes(image))


def save_gray(path: str, labels: np.ndarray) -> None:
    """``Image.fromarray(labels).convert("L").save(path)`` of uint8
    (H, W) labels."""
    write_png(path, np.asarray(labels, np.uint8))


def _segment_lut(data, n: int) -> np.ndarray:
    """matplotlib's ``_create_lookup_table`` for (x, y0, y1) segments at
    gamma 1."""
    a = np.array(data, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def _with_extremes(colours: np.ndarray) -> np.ndarray:
    """(N + 3, 4) float64: the N colours, then under (the first), over
    (the last) and bad (transparent black), as ``Colormap._init`` lays
    them."""
    n = len(colours)
    lut = np.ones((n + 3, 4))
    lut[:n, :3] = colours
    lut[n] = lut[0]
    lut[n + 1] = lut[n - 1]
    lut[n + 2] = 0.0
    return lut


def _jet_table() -> np.ndarray:
    return _with_extremes(np.stack([_segment_lut(_JET_DATA[name], _JET_N)
                                    for name in ("red", "green", "blue")], 1))


JET_LUT = _jet_table()
TAB20_LUT = _with_extremes(np.array(
    [[int(h[i:i + 2], 16) / 255 for i in (0, 2, 4)] for h in _TAB20_HEX]))


def _lookup(lut: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``Colormap.__call__`` of floats: (..., 4) float64 RGBA from the
    table ``lut`` of N colours and the three extremes."""
    if not x.dtype.is_floating_point:
        raise TypeError("a colour map takes floats in [0, 1]")
    n = len(lut) - 3
    xa = x * n
    xa = torch.where(xa == n, xa.new_tensor(n - 1), xa)
    idx = torch.nan_to_num(xa, nan=0.0).clamp(-1, n).long()
    idx = torch.where(xa < 0, n, idx)
    idx = torch.where(xa >= n, n + 1, idx)
    idx = torch.where(torch.isnan(xa), n + 2, idx)
    return torch.as_tensor(lut, device=x.device)[idx]


def jet(x: torch.Tensor) -> torch.Tensor:
    """``plt.cm.jet(x)`` of a float tensor: (..., 4) float64 RGBA on
    ``x``'s device.  ``x * 256`` is taken in ``x``'s dtype (exact: a power
    of two) and truncated; 1.0 takes the last colour, values outside
    [0, 1] the under and over colours, NaN the bad one."""
    return _lookup(JET_LUT, x)


def tab20(x: torch.Tensor) -> torch.Tensor:
    """``matplotlib.cm.tab20(x)`` of a float tensor, as ``jet``."""
    return _lookup(TAB20_LUT, x)


def tab20_bytes(labels: torch.Tensor) -> np.ndarray:
    """uint8 (H, W, 3): ``cm.tab20(Normalize(vmin, vmax)(labels),
    bytes=True)`` without alpha, vmin and vmax the labels' own (all
    labels equal map to 0).  Normalize takes integer labels in float64."""
    x = torch.as_tensor(labels).double()
    lo, hi = x.min(), x.max()
    x = torch.zeros_like(x) if bool(lo == hi) else (x - lo) / (hi - lo)
    return (tab20(x)[..., :3] * 255).to(torch.uint8).cpu().numpy()
