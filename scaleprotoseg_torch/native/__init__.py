"""Native (C++) training augmentation: ``fastaug.cc``, bound with ctypes.

``fastaug`` computes a training crop in one pass over its output pixels
(bilinear image and PIL-NEAREST label resize, the label table, mean
padding, crop, flip, normalization), bit-equal to the numpy pipeline of
``data/dataset.py`` (``resized_window``, flip, normalize).  ctypes
releases the GIL for the call, so loader threads augment in parallel.

The library is built with ``g++`` at first use into ``build/native/`` at
the root of the checkout, named by a hash of the source, the compiler and
its flags: an edited source rebuilds, an unchanged one is reused.  It is
compiled to a temporary name and renamed onto the final one, so that
processes building at once (test workers, loader workers, a relaunched
trainer) never load a half-written library.  A failed build raises with
the compiler's output; nothing falls back quietly.  ``SPS_NATIVE_AUG=0``
in the environment opts out: ``native_available()`` is then False and
the datasets take the numpy pipeline.

``build(source)`` builds any other source of this directory the same way
(``codecs.cc``, the image decoders of ``scaleprotoseg_torch.codecs``).
The module imports neither torch nor PIL, so that preprocessing workers
start quickly.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "fastaug.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
COMPILER = "g++"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_u8 = ctypes.POINTER(ctypes.c_uint8)
_i32 = ctypes.POINTER(ctypes.c_int32)
_f32 = ctypes.POINTER(ctypes.c_float)
_ARGTYPES = [
    _u8, _u8,                          # image (in_h, in_w, 3), label
    ctypes.c_int, ctypes.c_int,        # in_h, in_w
    _u8,                               # 256-entry label table
    ctypes.c_int, ctypes.c_int,        # resized rs_h, rs_w
    _i32, _i32,                        # PIL-NEAREST row / column maps
    ctypes.c_int, ctypes.c_int,        # window
    ctypes.c_int, ctypes.c_int,        # crop start
    ctypes.c_int,                      # flip
    _f32, _f32,                        # mean, std
    ctypes.c_int,                      # normalize
    _f32, _i32,                        # out image, out label
]


def library_path(source: Optional[Path] = None) -> Path:
    """``build/native/lib<stem>-<hash>.so`` of ``source`` (``fastaug.cc``
    by default)."""
    source = SOURCE if source is None else Path(source)
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join((COMPILER, *FLAGS)).encode())
    return BUILD_DIR / f"lib{source.stem}-{digest.hexdigest()[:12]}.so"


def build(source: Optional[Path] = None) -> Path:
    """The library's path, compiled first if it is missing.  Raises
    ``RuntimeError`` with the compiler's output if the build fails."""
    source = SOURCE if source is None else Path(source)
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = [COMPILER, *FLAGS, "-o", str(tmp), str(source)]
    what = f"native {source.name}"
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"{what}: cannot build with "
                           f"{' '.join(cmd)}: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what}: {' '.join(cmd)} exited "
                           f"{res.returncode}:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    """The loaded library, built on first use (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.fastaug.argtypes = _ARGTYPES
            lib.fastaug.restype = None
            _lib = lib
        return _lib


def native_available() -> bool:
    """False when ``SPS_NATIVE_AUG=0`` opts out; otherwise builds and
    loads the library and returns True, or raises if the build fails."""
    if os.environ.get("SPS_NATIVE_AUG", "1") == "0":
        return False
    load_library()
    return True


def fastaug(image: np.ndarray, label: np.ndarray, lut: np.ndarray,
            resized: Tuple[int, int], window: Tuple[int, int],
            start: Tuple[int, int], flip: bool, mean: Sequence[float],
            std: Sequence[float], normalize: bool = True
            ) -> Tuple[np.ndarray, np.ndarray]:
    """One training crop of ``image`` (uint8 (H, W, 3)) and its raw
    ``label`` (H, W) through the 256-entry table ``lut``: resized to
    ``resized``, padded bottom/right to ``window`` with ``mean`` (label
    0), the ``window`` at ``start``, flipped, and normalized with
    ``mean``/``std`` unless ``normalize`` is false.  Returns (image
    float32 (win_h, win_w, 3), label int32 (win_h, win_w))."""
    image = np.ascontiguousarray(image, np.uint8)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"fastaug: image of shape {image.shape}, want "
                         "(H, W, 3)")
    in_h, in_w = image.shape[:2]
    if label.shape != (in_h, in_w):
        raise ValueError(f"fastaug: label of shape {label.shape} for an "
                         f"image of {image.shape}")
    if label.dtype != np.uint8:
        if label.size and (label.min() < 0 or label.max() > 255):
            raise ValueError("fastaug: label values outside 0-255")
    label = np.ascontiguousarray(label, np.uint8)
    lut = np.ascontiguousarray(lut, np.uint8)
    if lut.shape != (256,):
        raise ValueError(f"fastaug: label table of shape {lut.shape}")
    (rs_h, rs_w), (win_h, win_w) = resized, window
    start_h, start_w = int(start[0]), int(start[1])
    if min(rs_h, rs_w, win_h, win_w) < 1 or min(start_h, start_w) < 0:
        raise ValueError(f"fastaug: resized {resized}, window {window}, "
                         f"start {start}")
    mean32 = np.ascontiguousarray(mean, np.float32)
    std32 = np.ascontiguousarray(std, np.float32)
    if mean32.shape != (3,) or std32.shape != (3,):
        raise ValueError("fastaug: mean and std take 3 values")
    from scaleprotoseg_torch.ops.resize import _nearest_index
    rows = np.ascontiguousarray(_nearest_index(rs_h, in_h), np.int32)
    cols = np.ascontiguousarray(_nearest_index(rs_w, in_w), np.int32)
    out_img = np.empty((win_h, win_w, 3), np.float32)
    out_label = np.empty((win_h, win_w), np.int32)
    load_library().fastaug(
        image.ctypes.data_as(_u8), label.ctypes.data_as(_u8), in_h, in_w,
        lut.ctypes.data_as(_u8), rs_h, rs_w, rows.ctypes.data_as(_i32),
        cols.ctypes.data_as(_i32), win_h, win_w, start_h, start_w,
        int(bool(flip)), mean32.ctypes.data_as(_f32),
        std32.ctypes.data_as(_f32), int(bool(normalize)),
        out_img.ctypes.data_as(_f32), out_label.ctypes.data_as(_i32))
    return out_img, out_label
