"""IoU between prototype activation masks.

    python -m scaleprotoseg_torch.analysis.prototype_overlap MODEL_NAME \\
        PHASE DATA_TYPE [--quantile Q] [--n-images N] [--device cuda|cpu]

The port of the JAX package's ``analysis/prototype_overlap.py``: for N val
images (``default_rng(0).choice``), each prototype's activation map is
thresholded at its quantile, and each pair of one class's prototypes gets
the IoU of their masks (low overlap: the prototypes specialize on
different regions).  A class's masks are thresholded in one batch on the
device and their intersections taken as one product of the flattened
masks.  Writes ``<run>/analysis/prototype_overlap/<phase>/
pair_iou_qt_Q.csv`` and ``summary.json`` (the mean and per-class mean
IoU).  Runs on ``cuda`` unless ``--device`` names another device; without
a card that is an error.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
from typing import List, Optional

import numpy as np
import torch

from scaleprotoseg_torch.analysis.common import (
    activation_from_distance, add_cli_args, class_protos, load_eval_model,
    load_image, make_distance_fn, output_dir, pair_ious, quantile_masks,
    sample_ids, val_image_ids)
from scaleprotoseg_torch.analysis.tables import column_mean, write_csv
from scaleprotoseg_torch.train.metrics import create_logger

COLUMNS = ["img_id", "class", "proto_a", "proto_b", "iou"]


def pair_rows(img_id: str, c: int, ids, ious: np.ndarray) -> list:
    """[img_id, class, a, b, IoU] of every pair of ``ids`` in order."""
    return [[img_id, int(c), int(ids[i]), int(ids[j]), float(ious[i, j])]
            for i, j in itertools.combinations(range(len(ids)), 2)]


def write_overlap(out_dir: str, quantile: float, columns, rows: list,
                  per_class: bool) -> float:
    """The pair CSV and ``summary.json``; returns the mean IoU."""
    write_csv(os.path.join(out_dir, f"pair_iou_qt_{quantile}.csv"),
              columns, rows)
    mean = column_mean([r[-1] for r in rows])
    summary = {"mean_iou": mean}
    if per_class:
        by_class = {}
        for r in rows:
            by_class.setdefault(r[1], []).append(r[-1])
        summary["per_class"] = {str(k): column_mean(by_class[k])
                                for k in sorted(by_class)}
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    return mean


def run_proto_activation(model_name: str, training_phase: str,
                         data_type: str, quantile: float = 0.8,
                         n_images: int = 20,
                         results_root: Optional[str] = None,
                         data_root: Optional[str] = None,
                         device=None) -> list:
    """Rows of [img_id, class, proto_a, proto_b, iou]."""
    log = create_logger(None)
    model, spec, model_path, dev = load_eval_model(
        model_name, training_phase, results_root, device)
    img_dir, _, ids = val_image_ids(data_type, data_root)
    distance_fn = make_distance_fn(model)

    rows = []
    for img_id in sample_ids(ids, n_images):
        d = distance_fn(load_image(img_dir, img_id, dev)[1])
        for c in range(spec.num_classes):
            protos = class_protos(spec, c)
            if len(protos) < 2:
                continue
            pk = torch.as_tensor(protos, device=dev)
            act = activation_from_distance(d.index_select(2, pk))
            masks = quantile_masks(act.permute(2, 0, 1), quantile)
            rows += pair_rows(img_id, c, protos, pair_ious(masks))
    out_dir = output_dir(model_path, "prototype_overlap", training_phase)
    mean = write_overlap(out_dir, quantile, COLUMNS, rows, per_class=True)
    log(f"prototype_overlap: mean pair IoU = {mean:.4f}")
    return rows


def main(argv: Optional[List[str]] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__)
    add_cli_args(p)
    p.add_argument("--quantile", type=float, default=0.8)
    p.add_argument("--n-images", type=int, default=20)
    a = p.parse_args(argv)
    return run_proto_activation(a.model_name, a.training_phase, a.data_type,
                                quantile=a.quantile, n_images=a.n_images,
                                device=a.device)


if __name__ == "__main__":
    main()
