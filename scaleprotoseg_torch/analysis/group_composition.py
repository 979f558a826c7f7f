"""Group composition: which prototypes each group uses.

    python -m scaleprotoseg_torch.analysis.group_composition MODEL_NAME \\
        PHASE [--weight-threshold W] [--device cuda|cpu]

The port of the JAX package's ``analysis/group_composition.py``: for each
class and group, the prototypes whose group-projection weight is above W
(weight, scale; heaviest first) go to ``<run>/analysis/group_composition/
<phase>/composition.json``, and each member's pushed images
(``<run>/prototypes/<p>/nearest-1_{original,patch,bbox}.png``, where push
wrote them) are copied to ``class_<c>/group_<k>/``.  Needs a grouped
model, loaded on ``cuda`` unless ``--device`` names another device;
without a card that is an error.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
from typing import List, Optional

from scaleprotoseg_torch.analysis.common import (add_cli_args, class_protos,
                                                 load_eval_model, output_dir)
from scaleprotoseg_torch.train.metrics import create_logger


def group_comp(model_name: str, training_phase: str,
               weight_threshold: float = 0.0,
               results_root: Optional[str] = None, device=None) -> dict:
    log = create_logger(None)
    model, spec, model_path, _ = load_eval_model(
        model_name, training_phase, results_root, device)
    if not model.grouped:
        raise ValueError("group_composition requires a grouped model")
    gw = model.group_weights()[0].detach().cpu().numpy()   # (C, G, Pc)

    out_dir = output_dir(model_path, "group_composition", training_phase)
    proto_img_dir = os.path.join(model_path, "prototypes")
    composition = {}
    for c in range(spec.num_classes):
        protos = class_protos(spec, c)
        for k in range(spec.num_groups):
            members = [{"proto_id": int(p), "weight": float(gw[c, k, j]),
                        "scale": int(spec.scale_ids[p])}
                       for j, p in enumerate(protos)
                       if float(gw[c, k, j]) > weight_threshold]
            members.sort(key=lambda m: -m["weight"])
            composition[f"class_{c}_group_{k}"] = members
            grp_dir = os.path.join(out_dir, f"class_{c}", f"group_{k}")
            for m in members:
                for suffix in ("_original.png", "_patch.png", "_bbox.png"):
                    src = os.path.join(proto_img_dir, str(m["proto_id"]),
                                       "nearest-1" + suffix)
                    if os.path.exists(src):
                        os.makedirs(grp_dir, exist_ok=True)
                        shutil.copy(src, os.path.join(
                            grp_dir, f"proto_{m['proto_id']}{suffix}"))
    with open(os.path.join(out_dir, "composition.json"), "w") as f:
        json.dump(composition, f, indent=2)
    log(f"group_composition: wrote {out_dir}")
    return composition


def main(argv: Optional[List[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    add_cli_args(p, data_type=False)
    p.add_argument("--weight-threshold", type=float, default=0.0)
    a = p.parse_args(argv)
    return group_comp(a.model_name, a.training_phase,
                      weight_threshold=a.weight_threshold, device=a.device)


if __name__ == "__main__":
    main()
