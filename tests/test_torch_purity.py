"""The port imports neither JAX, flax nor the JAX package.

Checked in a fresh interpreter: every module of ``scaleprotoseg_torch``
and the ``chip_smoke.py`` script are imported, then ``sys.modules`` must
hold no ``jax``/``flax`` module, nothing of ``scaleprotoseg_tpu``, and
neither ``cv2`` nor ``grain``, which the GPU machine does not have.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import scaleprotoseg_torch
names = [m.name for m in pkgutil.walk_packages(scaleprotoseg_torch.__path__,
                                               "scaleprotoseg_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "scaleprotoseg_tpu", "cv2", "grain"))
missing = sorted({"scaleprotoseg_torch." + m for m in (
    "ops.simplex", "push.push", "models.group_init",
    "finetune_wandb_group", "push.artifacts", "find_nearest", "prune",
    "run_pruning", "train_wandb", "analysis.threshold_save", "eval_test",
    "imageio", "helpers", "native", "data.jitter",
    "data.worker_loader", "ops.gradconv", "profiling")} - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 20 else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
