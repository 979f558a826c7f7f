"""Offline dataset preprocessing: raw downloads -> the on-disk layout the
datasets read.

    <DATA_PATH>/annotations/{split}/{img_id}.npy          (uint8 label ids)
    <DATA_PATH>/img_with_margin_{M}/{split}/{img_id}.png  (+ .npy mirror)
    <DATA_PATH>/all_images.json                           (split index)

The port of the JAX package's ``data/preprocess.py``, with the same
outputs: the same index (ids in sorted listing order: ``pool.map`` keeps
job order), the same label and image arrays, PNGs that decode to the same
pixels (the bytes differ: ``codecs`` writes filter 0 at its own zlib
level).  Images are decoded by ``scaleprotoseg_torch.codecs``, bit-equal
to PIL, and nothing here imports PIL, torch or the JAX package, so the
process-pool workers start quickly on the GPU machine.

Label conventions, as the JAX package's:

- cityscapes: official ids -> the 29-category index (``_city_lut``); the
  label is read as ``convert("RGB")[:, :, 0]``;
- pascal: ``SegmentationClassAug`` ids stored as read, no label for
  ``test``; ``convert("RGB")[:, :, 0]`` of a palette PNG is the palette's
  red value, not the class index, as in the JAX package;
- ade: ids stored as read; ``training`` / ``validation`` -> ``train`` /
  ``val``;
- coco: ``convert("L")`` through ``COCO_LUT``;
- em: the TIFF stacks split into frames, labels ``convert("L")`` through
  ``EM_RGB_2_ID``, a seeded random val split of ``EM_VAL_SIZE`` frames
  drawn from its own ``RandomState`` (the ids of ``np.random.seed(seed);
  np.random.choice(...)`` without touching the global state).
"""

from __future__ import annotations

import json
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from scaleprotoseg_torch import codecs, settings
from scaleprotoseg_torch.constants import (CITYSCAPES_CATEGORIES,
                                           CITYSCAPES_ID_2_LABEL, COCO_LUT,
                                           EM_RGB_2_ID, EM_VAL_SIZE,
                                           mapping_to_lut)

MARGIN_SIZE = 0


def add_margins_to_image(img: np.ndarray, margin: int) -> np.ndarray:
    """Mirror-pad an (H, W, C) image by ``margin`` on all sides, the edge
    pixel repeated ('symmetric')."""
    if margin == 0:
        return img
    return np.pad(img, ((margin, margin), (margin, margin), (0, 0)),
                  mode="symmetric")


def _save_pair(image: np.ndarray, label: Optional[np.ndarray],
               target: str, split: str, img_id: str, margin: int) -> None:
    ann_dir = os.path.join(target, "annotations", split)
    img_dir = os.path.join(target, f"img_with_margin_{margin}", split)
    os.makedirs(ann_dir, exist_ok=True)
    os.makedirs(img_dir, exist_ok=True)
    if label is not None:
        np.save(os.path.join(ann_dir, f"{img_id}.npy"),
                label.astype(np.uint8))
    img_m = np.asarray(add_margins_to_image(image, margin), np.uint8)
    codecs.write_png(os.path.join(img_dir, f"{img_id}.png"), img_m)
    np.save(os.path.join(img_dir, f"{img_id}.npy"), img_m)


def _write_index(target: str, img_ids: Dict[str, List[str]]) -> None:
    with open(os.path.join(target, "all_images.json"), "w") as f:
        json.dump(img_ids, f)


def report(what: str, n: int, t0: float) -> None:
    """The closing line: ``what``, then the seconds since ``t0`` (the
    listing, the pool's start and every file written) and the rate."""
    secs = time.perf_counter() - t0
    print(f"{what} in {secs:.3f} s ({n / secs:.2f} images/s)")


def _run(fn, jobs, n_jobs: int):
    """``fn`` over ``jobs`` in a pool of ``n_jobs`` spawned processes (the
    caller may hold threads, which fork would copy half-way), results in
    job order.  The decoders are built first, so that the workers only
    load them."""
    codecs.load_library()
    with ProcessPoolExecutor(max_workers=n_jobs, mp_context=multiprocessing
                             .get_context("spawn")) as pool:
        yield from pool.map(fn, jobs, chunksize=8)


# ---------------------------------------------------------------------------
# Cityscapes
# ---------------------------------------------------------------------------
_CITY_CAT_LUT = None


def _city_lut() -> np.ndarray:
    global _CITY_CAT_LUT
    if _CITY_CAT_LUT is None:
        cat2idx = {c: i for i, c in enumerate(CITYSCAPES_CATEGORIES)}
        id2idx = {i: cat2idx[cat] for i, cat in
                  CITYSCAPES_ID_2_LABEL.items()}
        _CITY_CAT_LUT = mapping_to_lut(id2idx, 256)
    return _CITY_CAT_LUT


def _city_one(args):
    source, target, split, city, file = args
    img_id = file.split("_gtFine_labelIds.png")[0]
    label = codecs.read_rgb(os.path.join(
        source, "gtFine", split, city, file))[:, :, 0]
    label = _city_lut()[label]
    image = codecs.read_rgb(os.path.join(
        source, "leftImg8bit", split, city, img_id + "_leftImg8bit.png"))
    _save_pair(image, label, target, split, img_id, MARGIN_SIZE)
    return split, img_id


def preprocess_cityscapes(n_jobs: int = 8, source: Optional[str] = None,
                          target: Optional[str] = None) -> None:
    t0 = time.perf_counter()
    source = source or settings.source_data_path("cityscapes")
    target = target or settings.data_path("cityscapes")
    jobs = []
    for split in ("train", "val", "test"):
        split_dir = os.path.join(source, "gtFine", split)
        if not os.path.isdir(split_dir):
            continue
        for city in sorted(os.listdir(split_dir)):
            for file in sorted(os.listdir(os.path.join(split_dir, city))):
                if file.endswith("labelIds.png"):
                    jobs.append((source, target, split, city, file))
    img_ids: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    for split, img_id in _run(_city_one, jobs, n_jobs):
        img_ids[split].append(img_id)
    _write_index(target, img_ids)
    n = sum(map(len, img_ids.values()))
    report(f"cityscapes: {n} images", n, t0)


# ---------------------------------------------------------------------------
# Pascal VOC-2012 (aug)
# ---------------------------------------------------------------------------
def _pascal_one(args):
    source, target, split, img_id = args
    label = None
    if split != "test":
        label = codecs.read_rgb(os.path.join(
            source, "SegmentationClassAug", img_id + ".png"))[:, :, 0]
    image = codecs.read_rgb(os.path.join(source, "JPEGImages",
                                         img_id + ".jpg"))
    _save_pair(image, label, target, split, img_id, MARGIN_SIZE)
    return split, img_id


def preprocess_pascal(n_jobs: int = 8, source: Optional[str] = None,
                      target: Optional[str] = None) -> None:
    t0 = time.perf_counter()
    source = source or settings.source_data_path("pascal")
    target = target or settings.data_path("pascal")
    split_dir = os.path.join(source, "ImageSets", "SegmentationAug")
    jobs, img_ids = [], {}
    for split in ("train_aug", "train", "val", "test"):
        list_file = os.path.join(split_dir, f"{split}.txt")
        if not os.path.exists(list_file):
            continue
        img_ids[split] = []
        with open(list_file) as f:
            for line in f:
                img_id = line.strip().split("/")[-1].split(".")[0]
                if img_id:
                    jobs.append((source, target, split, img_id))
    for split, img_id in _run(_pascal_one, jobs, n_jobs):
        img_ids[split].append(img_id)
    _write_index(target, img_ids)
    n = sum(map(len, img_ids.values()))
    report(f"pascal: {n} images", n, t0)


# ---------------------------------------------------------------------------
# ADE20K (SceneParsing release)
# ---------------------------------------------------------------------------
def _ade_one(args):
    source, target, split, split_in, file = args
    img_id = file.split(".png")[0]
    label = codecs.read_rgb(os.path.join(
        source, "annotations", split_in, file))[:, :, 0]
    image = codecs.read_rgb(os.path.join(source, "images", split_in,
                                         img_id + ".jpg"))
    _save_pair(image, label, target, split, img_id, MARGIN_SIZE)
    return split, img_id


def preprocess_ade(n_jobs: int = 8, source: Optional[str] = None,
                   target: Optional[str] = None) -> None:
    t0 = time.perf_counter()
    source = source or settings.source_data_path("ade")
    target = target or settings.data_path("ade")
    jobs = []
    img_ids: Dict[str, List[str]] = {}
    for split, split_in in (("train", "training"), ("val", "validation")):
        ann_dir = os.path.join(source, "annotations", split_in)
        if not os.path.isdir(ann_dir):
            continue
        img_ids[split] = []
        for file in sorted(os.listdir(ann_dir)):
            if file.endswith(".png"):
                jobs.append((source, target, split, split_in, file))
    for split, img_id in _run(_ade_one, jobs, n_jobs):
        img_ids[split].append(img_id)
    _write_index(target, img_ids)
    n = sum(map(len, img_ids.values()))
    report(f"ade: {n} images", n, t0)


# ---------------------------------------------------------------------------
# COCO-Stuff
# ---------------------------------------------------------------------------
def _coco_one(args):
    source, target, split, split_in, file = args
    img_id = file.split(".png")[0]
    label = COCO_LUT[codecs.read_l(os.path.join(
        source, "annotations", split_in, file))]
    image = codecs.read_rgb(os.path.join(source, "images", split_in,
                                         img_id + ".jpg"))
    _save_pair(image, label, target, split, img_id, MARGIN_SIZE)
    return split, img_id


def preprocess_coco(n_jobs: int = 8, source: Optional[str] = None,
                    target: Optional[str] = None) -> None:
    t0 = time.perf_counter()
    source = source or settings.source_data_path("coco")
    target = target or settings.data_path("coco")
    jobs = []
    img_ids: Dict[str, List[str]] = {}
    for split, split_in in (("train", "train2017"), ("val", "val2017")):
        ann_dir = os.path.join(source, "annotations", split_in)
        if not os.path.isdir(ann_dir):
            continue
        img_ids[split] = []
        for file in sorted(os.listdir(ann_dir)):
            if file.endswith(".png"):
                jobs.append((source, target, split, split_in, file))
    for split, img_id in _run(_coco_one, jobs, n_jobs):
        img_ids[split].append(img_id)
    _write_index(target, img_ids)
    n = sum(map(len, img_ids.values()))
    report(f"coco: {n} images", n, t0)


# ---------------------------------------------------------------------------
# EM / ISBI-2012
# ---------------------------------------------------------------------------
def em_val_ids(n_frames: int, seed: int) -> List[int]:
    """The held-out frames: ``np.random.seed(seed); np.random.choice(
    n_frames, EM_VAL_SIZE, replace=False)`` from a ``RandomState`` of its
    own, so the global numpy state is left as it was."""
    return np.random.RandomState(seed).choice(n_frames, EM_VAL_SIZE,
                                              replace=False).tolist()


def preprocess_em(n_jobs: int = 1, seed: int = 42,
                  source: Optional[str] = None,
                  target: Optional[str] = None) -> None:
    """``n_jobs`` is ignored, as in the JAX package: the frames are read
    in one process."""
    t0 = time.perf_counter()
    source = source or settings.source_data_path("em")
    target = target or settings.data_path("em")
    images = codecs.TiffFile(os.path.join(source, "train-volume.tif"))
    labels = codecs.TiffFile(os.path.join(source, "train-labels.tif"))
    lut = mapping_to_lut(EM_RGB_2_ID, 256)

    val_ids = em_val_ids(images.n_frames, seed)
    splits = {"train": [i for i in range(images.n_frames)
                        if i not in val_ids],
              "val": val_ids}
    img_ids: Dict[str, List[str]] = {"train": [], "val": []}
    for split, ids in splits.items():
        for i in ids:
            label = lut[codecs.to_l(*labels.page(i))]
            _save_pair(codecs.to_rgb(*images.page(i)), label, target, split,
                       str(i), MARGIN_SIZE)
            img_ids[split].append(str(i))
    _write_index(target, img_ids)
    report(f"em: {images.n_frames} frames (val={EM_VAL_SIZE})",
            images.n_frames, t0)


# ---------------------------------------------------------------------------
# PNG -> npy mirror
# ---------------------------------------------------------------------------
def img_to_numpy(data_type: str, margin: int = 0,
                 target: Optional[str] = None) -> None:
    t0 = time.perf_counter()
    target = target or settings.data_path(data_type)
    base = os.path.join(target, f"img_with_margin_{margin}")
    n = 0
    for split in sorted(os.listdir(base)):
        split_dir = os.path.join(base, split)
        for file in sorted(os.listdir(split_dir)):
            if file.endswith(".png"):
                img = codecs.read_rgb(os.path.join(split_dir, file))
                np.save(os.path.join(split_dir, file[:-4] + ".npy"),
                        np.asarray(img, np.uint8))
                n += 1
    report(f"{data_type}: {n} images", n, t0)
