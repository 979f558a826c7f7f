"""Decode Pascal Panoptic-Parts annotations for the interpretability
metrics.

``python -m scaleprotoseg_torch.data.preprocess_part_pascal [--source RAW]
[--target OUT] [--splits val ...]`` (the JAX package's arguments):
decodes the ``pascal_panoptic_parts/labels/{split}`` uid TIFFs (or PNGs)
into ``annotations_{PIDS,SIDS,IIDS}/{split}/{img_id}.npy``.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional

import numpy as np

from scaleprotoseg_torch import codecs, settings
from scaleprotoseg_torch.data.panoptic_parts_lite import decode_uids
from scaleprotoseg_torch.data.preprocess import report


def preprocess_part_pascal(source: Optional[str] = None,
                           target: Optional[str] = None,
                           splits=("val",)) -> None:
    t0, n = time.perf_counter(), 0
    source = source or settings.source_data_path("pascal")
    target = target or settings.data_path("pascal")
    parts_root = os.path.join(source, "pascal_panoptic_parts", "labels")
    for split in splits:
        split_dir = os.path.join(parts_root, split)
        if not os.path.isdir(split_dir):
            print(f"skipping {split}: {split_dir} not found")
            continue
        for kind in ("PIDS", "SIDS", "IIDS"):
            os.makedirs(os.path.join(target, f"annotations_{kind}",
                                     split), exist_ok=True)
        for file in sorted(os.listdir(split_dir)):
            if not file.endswith((".tif", ".png")):
                continue
            img_id = os.path.splitext(file)[0]
            uids = codecs.read_image(os.path.join(split_dir, file))[1]
            sids, iids, pids = decode_uids(uids)
            for kind, arr in (("PIDS", pids), ("SIDS", sids),
                              ("IIDS", iids)):
                np.save(os.path.join(target, f"annotations_{kind}",
                                     split, f"{img_id}.npy"), arr)
            n += 1
    report(f"done: {n} images", n, t0)


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--source", default=None)
    p.add_argument("--target", default=None)
    p.add_argument("--splits", nargs="+", default=["val"])
    a = p.parse_args()
    preprocess_part_pascal(source=a.source, target=a.target,
                           splits=tuple(a.splits))


if __name__ == "__main__":
    main()
