"""Zero the low group-projection weights of a grouped checkpoint and save.

    python -m scaleprotoseg_torch.analysis.threshold_save MODEL_NAME \\
        PHASE THRESHOLD [--results-root DIR] [--device cuda|cpu]

The port of the JAX package's ``analysis/threshold_save.py``, the grouped
model's pruning analog: every group-projection entry below THRESHOLD
becomes 0 and the rows are not re-normalised, as in the reference; the
result is saved as ``th-{THRESHOLD}-{PHASE}_last`` beside the source
checkpoint (``.pth`` and the sidecar, whose spec and ``extra`` it keeps),
the checkpoint of phase ``th-{THRESHOLD}-{PHASE}``.  A checkpoint without
a group projection is refused.  The comparison runs on ``cuda`` unless
``--device`` names another device; without a card that is an error.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import torch

from scaleprotoseg_torch import settings
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     save_checkpoint,
                                                     spec_from_meta)
from scaleprotoseg_torch.model_loading import (resolve_checkpoint,
                                               resolve_device)
from scaleprotoseg_torch.train.metrics import create_logger


def threshold_save(model_name: str, training_phase: str, threshold: float,
                   results_root: Optional[str] = None,
                   device: Optional[str] = None) -> str:
    """Returns the stem of the thresholded checkpoint."""
    dev = resolve_device(device)
    threshold = float(threshold)
    model_path = os.path.join(results_root or settings.results_dir(),
                              model_name)
    stem = os.path.splitext(resolve_checkpoint(model_path, training_phase))[0]
    log = create_logger(None)
    log(f"Loading model from {stem}.pth")
    sd, meta = load_checkpoint(stem)
    keys = [k for k in sd if k.startswith("group_projection.")]
    if not keys:
        raise ValueError("threshold_save requires a grouped model "
                         "checkpoint (no group_projection found)")
    sd = dict(sd)
    zeroed = 0
    for k in keys:
        w = sd[k].to(dev)
        low = w < threshold
        zeroed += int((low & (w != 0)).sum())
        sd[k] = torch.where(low, torch.zeros_like(w), w).cpu()
    out = os.path.join(os.path.dirname(stem),
                       f"th-{threshold}-{training_phase}_last")
    save_checkpoint(out, {k: v.numpy() for k, v in sd.items()},
                    spec_from_meta(meta["spec"]),
                    extra=(meta.get("extra") or {}))
    log(f"Saved thresholded model to {out}.pth ({zeroed} non-zero "
        f"group weights below {threshold} zeroed)")
    return out


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name")
    p.add_argument("training_phase")
    p.add_argument("threshold", type=float)
    p.add_argument("--results-root", default=None,
                   help="override the settings' results directory")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda, an error without one)")
    a = p.parse_args(argv)
    return threshold_save(a.model_name, a.training_phase, a.threshold,
                          results_root=a.results_root, device=a.device)


if __name__ == "__main__":
    main()
