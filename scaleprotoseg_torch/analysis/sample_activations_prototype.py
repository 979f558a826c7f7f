"""Prototype activation heatmaps on random validation samples.

    python -m scaleprotoseg_torch.analysis.sample_activations_prototype \\
        MODEL_NAME PHASE DATA_TYPE [--n-images N] [--device cuda|cpu]

The port of the JAX package's ``analysis/sample_activations_prototype.py``:
for N val images (``default_rng(0).choice``), ``<run>/analysis/
sample_activations_prototype/<phase>/<img_id>.png`` shows the input, the
prediction on the logit grid (tab20) and the activation maps (jet) of the
four prototypes with the largest activation on the image.  Runs on
``cuda`` unless ``--device`` names another device; without a card that
is an error.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from scaleprotoseg_torch.analysis.common import (
    activation_from_distance, add_cli_args, load_eval_model, load_image,
    make_forward_fn, output_dir, sample_ids, val_image_ids)
from scaleprotoseg_torch.analysis.panels import Figure
from scaleprotoseg_torch.train.metrics import create_logger


def sample_activations(model_name: str, training_phase: str,
                       data_type: str, n_images: int = 5,
                       protos_per_image: int = 4,
                       results_root: Optional[str] = None,
                       data_root: Optional[str] = None, device=None) -> None:
    log = create_logger(None)
    model, spec, model_path, dev = load_eval_model(
        model_name, training_phase, results_root, device)
    img_dir, _, ids = val_image_ids(data_type, data_root)
    forward = make_forward_fn(model)

    out_dir = output_dir(model_path, "sample_activations_prototype",
                         training_phase)
    for img_id in sample_ids(ids, n_images):
        img, x = load_image(img_dir, img_id, dev)
        out = forward(x)
        pred = out.logits[0].argmax(-1)
        act = activation_from_distance(out.distances[0])
        # strongest prototypes by max activation
        peak = act.reshape(-1, spec.num_active_prototypes).amax(0)
        top = np.argsort(-peak.cpu().numpy())[:protos_per_image]
        fig = Figure(protos_per_image + 2)
        fig.imshow(0, img)
        fig.set_title(0, "input")
        fig.imshow(1, pred.float(), cmap="tab20")
        fig.set_title(1, "prediction")
        for j, p in enumerate(top):
            fig.imshow(j + 2, act[:, :, p], cmap="jet")
            fig.set_title(j + 2,
                          f"p{p} c{int(np.argmax(spec.class_identity[p]))}")
        fig.savefig(os.path.join(out_dir, f"{img_id}.png"))
    log(f"sample_activations_prototype: wrote {out_dir}")


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_cli_args(p)
    p.add_argument("--n-images", type=int, default=5)
    a = p.parse_args(argv)
    sample_activations(a.model_name, a.training_phase, a.data_type,
                       n_images=a.n_images, device=a.device)


if __name__ == "__main__":
    main()
