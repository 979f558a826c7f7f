"""Environment-driven paths, read from the environment or a ``.env`` file
in the working directory: ``RESULTS_DIR`` (default ``results``) and the
preprocessed dataset roots (``DATA_PATH_CITY`` for Cityscapes,
``DATA_PATH_PASCAL`` for Pascal VOC-2012, ``DATA_PATH_COCO`` for
COCO-Stuff, ``DATA_PATH_ADE`` for ADE20K, and ``DATA_PATH_EM`` for the
evaluation of EM), and the raw downloads the preprocessing reads
(``SOURCE_DATA_PATH_CITY`` and the other four, each named as its
``DATA_PATH_*``)."""

from __future__ import annotations

import os

_DATA_ENV = {"cityscapes": "DATA_PATH_CITY", "pascal": "DATA_PATH_PASCAL",
             "ade": "DATA_PATH_ADE", "coco": "DATA_PATH_COCO",
             "em": "DATA_PATH_EM"}


def _dotenv(path: str = ".env") -> dict:
    out = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            out[key.strip()] = value.strip().strip("'\"")
    return out


def _env(key: str, default: str = "") -> str:
    return os.environ.get(key) or _dotenv().get(key, default)


def results_dir() -> str:
    return _env("RESULTS_DIR", "results")


def data_path(data_type: str) -> str:
    """The preprocessed dataset directory of ``data_type``."""
    if data_type not in _DATA_ENV:
        raise NotImplementedError(
            f"data type {data_type!r} is not ported yet; the port reads "
            f"{sorted(_DATA_ENV)}")
    key = _DATA_ENV[data_type]
    path = _env(key)
    if not path:
        raise RuntimeError(f"{key} is not set; point it at the preprocessed "
                           f"{data_type} directory (or pass --data-root)")
    return path


def source_data_path(data_type: str) -> str:
    """The raw download of ``data_type`` (``SOURCE_DATA_PATH_CITY``, ...);
    the empty string when unset, so paths under it are relative to the
    working directory, as in the JAX package."""
    if data_type not in _DATA_ENV:
        raise NotImplementedError(
            f"data type {data_type!r} is not ported yet; the port reads "
            f"{sorted(_DATA_ENV)}")
    return _env("SOURCE_" + _DATA_ENV[data_type])
