"""Stability interpretability metric.

    python -m scaleprotoseg_torch.analysis.metrics.stability MODEL_NAME \\
        PHASE DATA_TYPE [--quantile Q] [--std-dev S] [--group-name G] \\
        [--limit N] [--device cuda|cpu]

The port of the JAX package's ``analysis/metrics/stability.py``: each
prototype's part hits (``parts.part_intersect``, absent parts 0) on the
clean val image and on the image with Gaussian noise of std S added
(``default_rng(0)``, image after image, as the JAX package draws it; one
model load for both passes); a
row is *stable* when every part agrees, and the score is the mean over
the (image, class, prototype) rows.  Writes
``<run>/metrics/<phase>/tot_presence_stab_qt_Q.csv`` and
``stability_score_qt_Q.txt``.  Runs on ``cuda`` unless ``--device`` names
another device; without a card that is an error.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from scaleprotoseg_torch.analysis.common import (add_cli_args,
                                                 load_eval_model)
from scaleprotoseg_torch.analysis.metrics.consistency import (
    collect_presence, part_columns)
from scaleprotoseg_torch.analysis.tables import (column_mean, inner_merge,
                                                 records, write_csv)
from scaleprotoseg_torch.train.metrics import create_logger

KEYS = ["proto_id", "class", "img_id"]


def run_stability(model_name: str, training_phase: str, data_type: str,
                  quantile: float = 0.8, std_dev: float = 0.2,
                  group_name: Optional[str] = None,
                  results_root: Optional[str] = None,
                  data_root: Optional[str] = None,
                  limit: Optional[int] = None, device=None) -> float:
    log = create_logger(None)
    loaded = load_eval_model(model_name, training_phase, results_root,
                             device)
    (clean, max_parts), (noisy, _) = [collect_presence(
        loaded, data_type, quantile, group_name, results_root, data_root,
        log, noise_std=noise, nan_missing_parts=False, limit=limit)
        for noise in (None, std_dev)]
    model_path = loaded[2]
    out_dir = os.path.join(model_path, "metrics", training_phase)
    os.makedirs(out_dir, exist_ok=True)

    part_cols = part_columns(max_parts)
    stab_cols = part_columns(max_parts, "part_stab_")
    eq_cols = part_columns(max_parts, "eq_part_")
    tot = inner_merge(records(part_cols + KEYS, clean),
                      records(stab_cols + KEYS, noisy), KEYS)
    for r in tot:
        for i, eq in enumerate(eq_cols):
            r[eq] = int(r[part_cols[i]] == r[stab_cols[i]])
        r["is_stable"] = int(sum(r[c] for c in eq_cols) == max_parts + 1)
    columns = part_cols + KEYS + stab_cols + eq_cols + ["is_stable"]
    write_csv(os.path.join(out_dir, f"tot_presence_stab_qt_{quantile}.csv"),
              columns, [[r[c] for c in columns] for r in tot])
    score = column_mean([r["is_stable"] for r in tot])
    log(f"Stability score: {score}")
    with open(os.path.join(out_dir,
                           f"stability_score_qt_{quantile}.txt"), "w") as f:
        f.write(f"{score}")
    return score


def main(argv: Optional[List[str]] = None) -> float:
    p = argparse.ArgumentParser(description=__doc__)
    add_cli_args(p)
    p.add_argument("--quantile", type=float, default=0.8)
    p.add_argument("--std-dev", type=float, default=0.2)
    p.add_argument("--group-name", default=None)
    p.add_argument("--limit", type=int, default=None)
    a = p.parse_args(argv)
    return run_stability(a.model_name, a.training_phase, a.data_type,
                         quantile=a.quantile, std_dev=a.std_dev,
                         group_name=a.group_name, limit=a.limit,
                         device=a.device)


if __name__ == "__main__":
    main()
