"""Consistency interpretability metric.

    python -m scaleprotoseg_torch.analysis.metrics.consistency MODEL_NAME \\
        PHASE DATA_TYPE [--quantile Q] [--threshold T] [--group-name G] \\
        [--limit N] [--device cuda|cpu]

The port of the JAX package's ``analysis/metrics/consistency.py``: a
prototype is *consistent* when, averaged over the val images holding its
class, its quantile-thresholded activation hits one object part (the
part-centroid test of ``parts.part_intersect``) in more than THRESHOLD of
them; the score is the share of consistent prototypes.  Reads the
``annotations_PIDS/val`` part annotations the part preprocessors write,
and with ``--group-name`` keeps only the prototypes that group run's
``th-0.05-nopush-group_last`` checkpoint uses.  Writes
``<run>/metrics/<phase>/part_presence_th_T_qt_Q.csv``, its per-prototype
mean ``part_presence_mean_th_T_qt_Q.csv`` and
``consistency_score_th_T_qt_Q.txt``.  The forward and the part pass run on
``cuda`` unless ``--device`` names another device; without a card that
is an error.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from scaleprotoseg_torch import settings
from scaleprotoseg_torch.analysis.common import (add_cli_args, dataset_meta,
                                                 load_eval_model, load_image,
                                                 load_label,
                                                 make_distance_fn,
                                                 proto_filter, val_image_ids)
from scaleprotoseg_torch.analysis.metrics.parts import part_intersect
from scaleprotoseg_torch.analysis.tables import (column_mean, group_mean,
                                                 records, write_csv)
from scaleprotoseg_torch.checkpoints.convert import load_checkpoint
from scaleprotoseg_torch.train.metrics import create_logger


def part_columns(max_parts: int, prefix: str = "part_") -> List[str]:
    return [f"{prefix}{i}" for i in range(max_parts + 1)]


def collect_presence(loaded, data_type: str, quantile: float,
                     group_name: Optional[str], results_root, data_root,
                     log, noise_std: Optional[float] = None,
                     nan_missing_parts: bool = True, limit=None):
    """(rows of ``part_intersect`` over the val images with part
    annotations, max_parts) of the model ``loaded`` (``load_eval_model``'s
    tuple).  ``noise_std`` adds ``default_rng(0).standard_normal`` noise
    to each normalized image in turn, as the JAX package draws it."""
    model, spec, _, dev = loaded
    cls2name, max_parts, filter_class = dataset_meta(data_type)

    proto_ids = None
    if group_name is not None:
        stem = os.path.join(results_root or settings.results_dir(),
                            group_name, "checkpoints",
                            "th-0.05-nopush-group_last")
        gstate, _ = load_checkpoint(stem)
        proto_ids = proto_filter(gstate, spec)
        log(f"Group filter keeps {len(proto_ids)} prototypes")

    img_dir, ann_dir, ids = val_image_ids(data_type, data_root)
    part_dir = os.path.join(os.path.dirname(ann_dir) + "_PIDS", "val")
    distance_fn = make_distance_fn(model)
    rng = np.random.default_rng(0)
    kw = dict(spec=spec, cls2name=cls2name, quantile=quantile,
              max_parts=max_parts, filter_proto_ids=proto_ids,
              filter_class_ids=filter_class,
              nan_missing_parts=nan_missing_parts)

    rows = []
    n = 0
    for img_id in ids:
        part_path = os.path.join(part_dir, img_id + ".npy")
        if not os.path.exists(part_path):
            continue  # only the images with part annotations
        if limit and n >= limit:
            break
        n += 1
        part_ann = np.load(part_path)
        cls_ann = load_label(ann_dir, img_id, data_type)
        _, x = load_image(img_dir, img_id, dev)
        if noise_std is not None:
            noise = noise_std * rng.standard_normal(x.shape).astype(
                np.float32)
            x = x + torch.from_numpy(noise).to(x.device)
        d = distance_fn(x)
        rows.extend(part_intersect(d, cls_ann, part_ann, img_id=img_id,
                                   **kw))
    return rows, max_parts


def run_consistency(model_name: str, training_phase: str, data_type: str,
                    quantile: float = 0.8, threshold: float = 0.8,
                    group_name: Optional[str] = None,
                    results_root: Optional[str] = None,
                    data_root: Optional[str] = None,
                    limit: Optional[int] = None, device=None) -> float:
    log = create_logger(None)
    loaded = load_eval_model(model_name, training_phase, results_root,
                             device)
    rows, max_parts = collect_presence(loaded, data_type, quantile,
                                       group_name, results_root, data_root,
                                       log, limit=limit)
    model_path = loaded[2]
    out_dir = os.path.join(model_path, "metrics", training_phase)
    os.makedirs(out_dir, exist_ok=True)

    part_cols = part_columns(max_parts)
    columns = part_cols + ["proto_id", "class", "img_id"]
    write_csv(os.path.join(
        out_dir, f"part_presence_th_{threshold}_qt_{quantile}.csv"),
        columns, rows)

    means = group_mean(records(columns, rows), ["class", "proto_id"],
                       part_cols)
    for m in means:
        # NaN > threshold is False, as pandas compares it
        m["is_consistent"] = int(any(m[c] > threshold for c in part_cols))
    mean_cols = ["class", "proto_id", *part_cols, "is_consistent"]
    write_csv(os.path.join(
        out_dir, f"part_presence_mean_th_{threshold}_qt_{quantile}.csv"),
        mean_cols, [[m[c] for c in mean_cols] for m in means])
    score = column_mean([m["is_consistent"] for m in means])
    log(f"Consistency score: {score}")
    with open(os.path.join(
            out_dir,
            f"consistency_score_th_{threshold}_qt_{quantile}.txt"),
            "w") as f:
        f.write(f"{score}")
    return score


def main(argv: Optional[List[str]] = None) -> float:
    p = argparse.ArgumentParser(description=__doc__)
    add_cli_args(p)
    p.add_argument("--quantile", type=float, default=0.8)
    p.add_argument("--threshold", type=float, default=0.8)
    p.add_argument("--group-name", default=None)
    p.add_argument("--limit", type=int, default=None)
    a = p.parse_args(argv)
    return run_consistency(a.model_name, a.training_phase, a.data_type,
                           quantile=a.quantile, threshold=a.threshold,
                           group_name=a.group_name, limit=a.limit,
                           device=a.device)


if __name__ == "__main__":
    main()
