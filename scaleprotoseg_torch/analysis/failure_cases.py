"""Failure-case inspection: activations on mispredicted regions.

    python -m scaleprotoseg_torch.analysis.failure_cases MODEL_NAME PHASE \\
        DATA_TYPE [--n-images N] [--device cuda|cpu]

The port of the JAX package's ``analysis/failure_cases.py``: the val
images ranked by their pixel error rate on the logit grid (the label
resized there by PIL's nearest rule, void left out); for the N worst,
``<run>/analysis/failure_cases/<phase>/<img_id>.png`` shows the input,
the ground truth, the wrong pixels' predicted classes (tab20) and the
activation maps (jet) of the three prototypes of the most often wrongly
predicted class with the largest activation.  Runs on ``cuda`` unless
``--device`` names another device; without a card that is an error.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from scaleprotoseg_torch.analysis.common import (
    activation_from_distance, add_cli_args, class_protos, load_eval_model,
    load_image, load_label, make_forward_fn, output_dir, val_image_ids)
from scaleprotoseg_torch.analysis.panels import Figure
from scaleprotoseg_torch.ops.resize import resize_label_nearest
from scaleprotoseg_torch.train.metrics import create_logger


def failure_cases(model_name: str, training_phase: str, data_type: str,
                  n_images: int = 5, protos_per_case: int = 3,
                  results_root: Optional[str] = None,
                  data_root: Optional[str] = None, device=None) -> list:
    """[(error rate, img_id)] of every val image, worst first."""
    log = create_logger(None)
    model, spec, model_path, dev = load_eval_model(
        model_name, training_phase, results_root, device)
    img_dir, ann_dir, ids = val_image_ids(data_type, data_root)
    forward = make_forward_fn(model)

    # rank images by error rate at the prediction grid
    errors = []
    for img_id in ids:
        out = forward(load_image(img_dir, img_id, dev)[1])
        pred = out.logits[0].argmax(-1)
        ann = torch.as_tensor(load_label(ann_dir, img_id, data_type),
                              device=dev)
        t = resize_label_nearest(ann, *pred.shape) - 1
        valid = t >= 0
        err = float(((pred != t) & valid).sum().item() /
                    max(int(valid.sum()), 1))
        errors.append((err, img_id))
    errors.sort(reverse=True)

    out_dir = output_dir(model_path, "failure_cases", training_phase)
    for err, img_id in errors[:n_images]:
        img, x = load_image(img_dir, img_id, dev)
        out = forward(x)
        pred = out.logits[0].argmax(-1)
        ann = torch.as_tensor(load_label(ann_dir, img_id, data_type),
                              device=dev)
        t = resize_label_nearest(ann, *pred.shape) - 1
        wrong = (pred != t) & (t >= 0)
        if not bool(wrong.any()):
            continue
        # most common wrongly-predicted class
        wrong_cls = int(torch.bincount(pred[wrong],
                                       minlength=spec.num_classes).argmax())
        protos = class_protos(spec, wrong_cls)
        act = activation_from_distance(out.distances[0][:, :, protos])
        peak = act.reshape(-1, len(protos)).amax(0).cpu().numpy()
        strongest = protos[np.argsort(-peak)[:protos_per_case]]
        fig = Figure(protos_per_case + 3)
        fig.imshow(0, img)
        fig.set_title(0, f"input (err={err:.2f})")
        fig.imshow(1, t, cmap="tab20")
        fig.set_title(1, "GT")
        fig.imshow(2, torch.where(wrong, pred, -1), cmap="tab20")
        fig.set_title(2, f"errors (pred {wrong_cls})")
        for j, p in enumerate(strongest):
            fig.imshow(j + 3, activation_from_distance(
                out.distances[0][:, :, p]), cmap="jet")
            fig.set_title(j + 3, f"p{p}")
        fig.savefig(os.path.join(out_dir, f"{img_id}.png"))
    log(f"failure_cases: wrote {out_dir}")
    return errors


def main(argv: Optional[List[str]] = None) -> list:
    p = argparse.ArgumentParser(description=__doc__)
    add_cli_args(p)
    p.add_argument("--n-images", type=int, default=5)
    a = p.parse_args(argv)
    return failure_cases(a.model_name, a.training_phase, a.data_type,
                         n_images=a.n_images, device=a.device)


if __name__ == "__main__":
    main()
