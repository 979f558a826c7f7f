"""IoU between group activation masks.

    python -m scaleprotoseg_torch.analysis.group_overlap MODEL_NAME PHASE \\
        DATA_TYPE [--quantile Q] [--n-images N] [--device cuda|cpu]

The port of the JAX package's ``analysis/group_overlap.py``, the group
analog of ``prototype_overlap``: each group's activation map
(``group_activations`` of the eval forward) thresholded at its quantile,
and the IoU of each pair of one class's groups; every class's masks in
one batch on the device.  Writes ``<run>/analysis/group_overlap/<phase>/
pair_iou_qt_Q.csv`` and ``summary.json``.  Needs a grouped model.  Runs
on ``cuda`` unless ``--device`` names another device; without a card
that is an error.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np

from scaleprotoseg_torch.analysis.common import (add_cli_args,
                                                 load_eval_model, load_image,
                                                 make_forward_fn, output_dir,
                                                 pair_ious, quantile_masks,
                                                 sample_ids, val_image_ids)
from scaleprotoseg_torch.analysis.prototype_overlap import (pair_rows,
                                                            write_overlap)
from scaleprotoseg_torch.train.metrics import create_logger

COLUMNS = ["img_id", "class", "group_a", "group_b", "iou"]


def run_group_overlap(model_name: str, training_phase: str,
                      data_type: str, quantile: float = 0.8,
                      n_images: int = 20,
                      results_root: Optional[str] = None,
                      data_root: Optional[str] = None,
                      device=None) -> list:
    """Rows of [img_id, class, group_a, group_b, iou]."""
    log = create_logger(None)
    model, spec, model_path, dev = load_eval_model(
        model_name, training_phase, results_root, device)
    if not model.grouped:
        raise ValueError("group_overlap requires a grouped model")
    img_dir, _, ids = val_image_ids(data_type, data_root)
    forward = make_forward_fn(model)
    groups = np.arange(spec.num_groups)

    rows = []
    for img_id in sample_ids(ids, n_images):
        g = forward(load_image(img_dir, img_id, dev)[1]).group_activations[0]
        c_, g_ = spec.num_classes, spec.num_groups
        masks = quantile_masks(g.permute(2, 3, 0, 1).reshape(
            c_ * g_, *g.shape[:2]), quantile).reshape(c_, g_, -1)
        for c in range(c_):
            rows += pair_rows(img_id, c, groups, pair_ious(masks[c]))
    out_dir = output_dir(model_path, "group_overlap", training_phase)
    mean = write_overlap(out_dir, quantile, COLUMNS, rows, per_class=False)
    log(f"group_overlap: mean pair IoU = {mean:.4f}")
    return rows


def main(argv: Optional[List[str]] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__)
    add_cli_args(p)
    p.add_argument("--quantile", type=float, default=0.8)
    p.add_argument("--n-images", type=int, default=20)
    a = p.parse_args(argv)
    return run_group_overlap(a.model_name, a.training_phase, a.data_type,
                             quantile=a.quantile, n_images=a.n_images,
                             device=a.device)


if __name__ == "__main__":
    main()
