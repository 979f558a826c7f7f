"""Group activation heatmaps on random validation samples.

    python -m scaleprotoseg_torch.analysis.sample_activations_group \\
        MODEL_NAME PHASE DATA_TYPE [--n-images N] [--device cuda|cpu]

The port of the JAX package's ``analysis/sample_activations_group.py``:
for N val images (``default_rng(0).choice``), ``<run>/analysis/
sample_activations_group/<phase>/<img_id>.png`` shows the input, the
prediction on the logit grid (tab20) and the group activation maps (jet)
of the class predicted on most pixels.  Needs a grouped model.  Runs on
``cuda`` unless ``--device`` names another device; without a card that
is an error.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from scaleprotoseg_torch.analysis.common import (add_cli_args,
                                                 load_eval_model, load_image,
                                                 make_forward_fn, output_dir,
                                                 sample_ids, val_image_ids)
from scaleprotoseg_torch.analysis.panels import Figure
from scaleprotoseg_torch.train.metrics import create_logger


def sample_activations_group(model_name: str, training_phase: str,
                             data_type: str, n_images: int = 5,
                             results_root: Optional[str] = None,
                             data_root: Optional[str] = None,
                             device=None) -> None:
    log = create_logger(None)
    model, spec, model_path, dev = load_eval_model(
        model_name, training_phase, results_root, device)
    if not model.grouped:
        raise ValueError("requires a grouped model")
    img_dir, _, ids = val_image_ids(data_type, data_root)
    forward = make_forward_fn(model)

    out_dir = output_dir(model_path, "sample_activations_group",
                         training_phase)
    for img_id in sample_ids(ids, n_images):
        img, x = load_image(img_dir, img_id, dev)
        out = forward(x)
        pred = out.logits[0].argmax(-1)
        # dominant predicted class
        c = int(torch.bincount(pred.reshape(-1),
                               minlength=spec.num_classes).argmax())
        fig = Figure(spec.num_groups + 2)
        fig.imshow(0, img)
        fig.set_title(0, "input")
        fig.imshow(1, pred.float(), cmap="tab20")
        fig.set_title(1, f"prediction (class {c})")
        for j in range(spec.num_groups):
            fig.imshow(j + 2, out.group_activations[0][:, :, c, j],
                       cmap="jet")
            fig.set_title(j + 2, f"class {c} group {j}")
        fig.savefig(os.path.join(out_dir, f"{img_id}.png"))
    log(f"sample_activations_group: wrote {out_dir}")


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    add_cli_args(p)
    p.add_argument("--n-images", type=int, default=5)
    a = p.parse_args(argv)
    sample_activations_group(a.model_name, a.training_phase, a.data_type,
                             n_images=a.n_images, device=a.device)


if __name__ == "__main__":
    main()
