"""Top-n nearest validation images per prototype.

    python -m scaleprotoseg_torch.analysis.nearest_img MODEL_NAME PHASE \\
        DATA_TYPE [--top-n N] [--limit L] [--no-plots] [--device cuda|cpu]

The port of the JAX package's ``analysis/nearest_img.py``: each val image's
smallest distance to each prototype, void masked (+1e7 where the label,
resized to the distance grid by PIL's nearest rule, is void), ranks the
images per prototype; ``<run>/analysis/nearest_img/<phase>/
nearest_images.json`` holds the top N per prototype and ``proto_<p>.png``
(unless ``--no-plots``) the N images with the prototype's activation over
them (blocks of ``H // h + 1`` by ``W // w + 1`` pixels a cell, cropped;
jet at alpha 0.4).  The plots take one forward per image that appears in
any top list, not one per (prototype, rank), and keep the low-resolution
maps they need.  Runs on ``cuda`` unless
``--device`` names another device; without a card that is an error.
"""

from __future__ import annotations

import argparse
import json
import os
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from scaleprotoseg_torch.analysis.common import (
    activation_from_distance, add_cli_args, load_eval_model, load_image,
    load_label, make_distance_fn, output_dir, val_image_ids)
from scaleprotoseg_torch.analysis.panels import Figure
from scaleprotoseg_torch.ops.resize import resize_label_nearest
from scaleprotoseg_torch.train.metrics import create_logger

VOID_PENALTY = 1e7


def block_upsample(act: torch.Tensor, height: int, width: int
                   ) -> torch.Tensor:
    """``np.kron(act, ones((H // h + 1, W // w + 1)))[:H, :W]``."""
    h, w = act.shape
    return act.repeat_interleave(height // h + 1, 0).repeat_interleave(
        width // w + 1, 1)[:height, :width]


def nearest_img(model_name: str, training_phase: str, data_type: str,
                top_n: int = 5, results_root: Optional[str] = None,
                data_root: Optional[str] = None,
                limit: Optional[int] = None, save_plots: bool = True,
                device=None) -> dict:
    log = create_logger(None)
    model, spec, model_path, dev = load_eval_model(
        model_name, training_phase, results_root, device)
    img_dir, ann_dir, ids = val_image_ids(data_type, data_root)
    if limit:
        ids = ids[:limit]
    distance_fn = make_distance_fn(model)
    P = spec.num_active_prototypes  # the distances' width

    mins = np.full((len(ids), P), np.inf)
    for i, img_id in enumerate(ids):
        d = distance_fn(load_image(img_dir, img_id, dev)[1])
        ann = torch.as_tensor(load_label(ann_dir, img_id, data_type),
                              device=dev)
        void = resize_label_nearest(ann, d.shape[0], d.shape[1]) == 0
        dm = d.double() + VOID_PENALTY * void[..., None]
        mins[i] = dm.reshape(-1, P).amin(0).cpu().numpy()

    order = np.argsort(mins, axis=0)[:top_n]  # (top_n, P)
    n = min(top_n, len(ids))
    out_dir = output_dir(model_path, "nearest_img", training_phase)
    index = {str(p): [{"img_id": ids[int(order[r, p])],
                       "distance": float(mins[int(order[r, p]), p])}
                      for r in range(n)]
             for p in range(P)}
    with open(os.path.join(out_dir, "nearest_images.json"), "w") as f:
        json.dump(index, f, indent=2)

    if save_plots:
        # one forward an image in any top list; the maps it gives kept
        maps = {}
        for i in sorted(set(order[:n].ravel().tolist())):
            act = activation_from_distance(distance_fn(
                load_image(img_dir, ids[i], dev)[1]))
            for r, p in zip(*np.nonzero(order[:n] == i)):
                maps[r, p] = act[:, :, p].cpu()

        @lru_cache(maxsize=16)
        def image(i: int) -> torch.Tensor:
            return torch.as_tensor(np.load(os.path.join(
                img_dir, ids[i] + ".npy")), device=dev)

        # the PNGs are encoded and written on 4 threads
        with ThreadPoolExecutor(4) as pool:
            writes = []
            for p in range(P):
                fig = Figure(n)
                for r in range(n):
                    img = image(int(order[r, p]))
                    fig.imshow(r, img)
                    fig.imshow(r, block_upsample(maps[r, p].to(dev),
                                                 *img.shape[:2]),
                               cmap="jet", alpha=0.4)
                writes.append(fig.savefig(
                    os.path.join(out_dir, f"proto_{p}.png"), executor=pool))
            for w in writes:
                w.result()
    log(f"nearest_img: wrote {out_dir}")
    return index


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    add_cli_args(p)
    p.add_argument("--top-n", type=int, default=5)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--no-plots", action="store_true")
    a = p.parse_args(argv)
    return nearest_img(a.model_name, a.training_phase, a.data_type,
                       top_n=a.top_n, limit=a.limit,
                       save_plots=not a.no_plots, device=a.device)


if __name__ == "__main__":
    main()
