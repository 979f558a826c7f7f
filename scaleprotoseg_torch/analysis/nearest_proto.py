"""Nearest prototypes per validation image.

    python -m scaleprotoseg_torch.analysis.nearest_proto MODEL_NAME PHASE \\
        DATA_TYPE [--top-k K] [--n-images N] [--no-plots] \\
        [--device cuda|cpu]

The port of the JAX package's ``analysis/nearest_proto.py``: for N val
images (``default_rng(0).choice``), the prototypes ranked by their
smallest distance on the image; ``<run>/analysis/nearest_proto/<phase>/
nearest_prototypes.json`` holds the top K (class, scale, distance) and
``<img_id>.png`` (unless ``--no-plots``) the image beside the top K's
activation maps (jet).  Runs on ``cuda`` unless ``--device`` names another
device; without a card that is an error.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from scaleprotoseg_torch.analysis.common import (
    activation_from_distance, add_cli_args, load_eval_model, load_image,
    make_distance_fn, output_dir, sample_ids, val_image_ids)
from scaleprotoseg_torch.analysis.panels import Figure
from scaleprotoseg_torch.train.metrics import create_logger


def nearest_proto(model_name: str, training_phase: str, data_type: str,
                  top_k: int = 5, n_images: int = 10,
                  results_root: Optional[str] = None,
                  data_root: Optional[str] = None,
                  save_plots: bool = True, device=None) -> dict:
    log = create_logger(None)
    model, spec, model_path, dev = load_eval_model(
        model_name, training_phase, results_root, device)
    img_dir, _, ids = val_image_ids(data_type, data_root)
    distance_fn = make_distance_fn(model)
    proto_class = np.argmax(spec.class_identity, axis=1)

    out_dir = output_dir(model_path, "nearest_proto", training_phase)
    index = {}
    for img_id in sample_ids(ids, n_images):
        img, x = load_image(img_dir, img_id, dev)
        d = distance_fn(x)
        mins = d.reshape(-1, spec.num_active_prototypes).amin(0) \
            .cpu().numpy()
        top = np.argsort(mins)[:top_k]
        index[img_id] = [{"proto_id": int(p), "class": int(proto_class[p]),
                          "scale": int(spec.scale_ids[p]),
                          "distance": float(mins[p])} for p in top]
        if save_plots:
            fig = Figure(top_k + 1)
            fig.imshow(0, img)
            fig.set_title(0, img_id[:18])
            for j, p in enumerate(top):
                fig.imshow(j + 1, activation_from_distance(d[:, :, p]),
                           cmap="jet")
                fig.set_title(j + 1, f"p{p} c{proto_class[p]} "
                                     f"s{spec.scale_ids[p]}")
            fig.savefig(os.path.join(out_dir, f"{img_id}.png"))
    with open(os.path.join(out_dir, "nearest_prototypes.json"), "w") as f:
        json.dump(index, f, indent=2)
    log(f"nearest_proto: wrote {out_dir}")
    return index


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    add_cli_args(p)
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--n-images", type=int, default=10)
    p.add_argument("--no-plots", action="store_true")
    a = p.parse_args(argv)
    return nearest_proto(a.model_name, a.training_phase, a.data_type,
                         top_k=a.top_k, n_images=a.n_images,
                         save_plots=not a.no_plots, device=a.device)


if __name__ == "__main__":
    main()
