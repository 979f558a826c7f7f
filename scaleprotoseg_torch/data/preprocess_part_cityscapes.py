"""Decode Cityscapes Panoptic-Parts annotations for the interpretability
metrics.

``python -m scaleprotoseg_torch.data.preprocess_part_cityscapes
[--source RAW] [--target OUT] [--splits val ...]`` (the JAX package's
arguments): reads the ``gtFinePanopticParts/{split}/{city}/*.tif`` uid
TIFFs, decodes the uids into semantic, instance and part ids, and writes
``annotations_{PIDS,SIDS,IIDS}/{split}/{img_id}.npy`` next to the class
annotations.
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


def preprocess_part_cityscapes(source: Optional[str] = None,
                               target: Optional[str] = None,
                               splits=("val",)) -> None:
    t0, n = time.perf_counter(), 0
    source = source or settings.source_data_path("cityscapes")
    target = target or settings.data_path("cityscapes")
    parts_root = os.path.join(source, "gtFinePanopticParts")
    for split in splits:
        split_dir = os.path.join(parts_root, split)
        if not os.path.isdir(split_dir):
            print(f"skipping {split}: {split_dir} not found")
            continue
        for kind in ("PIDS", "SIDS", "IIDS"):
            os.makedirs(os.path.join(target, f"annotations_{kind}",
                                     split), exist_ok=True)
        for city in sorted(os.listdir(split_dir)):
            city_dir = os.path.join(split_dir, city)
            for file in sorted(os.listdir(city_dir)):
                if not file.endswith(".tif"):
                    continue
                img_id = file.split("_gtFinePanopticParts")[0]
                uids = codecs.read_image(os.path.join(city_dir, file))[1]
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
    preprocess_part_cityscapes(source=a.source, target=a.target,
                               splits=tuple(a.splits))


if __name__ == "__main__":
    main()
