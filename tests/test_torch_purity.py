"""The port imports neither JAX, flax nor the JAX package, nor an image
library the GPU machine lacks.

Checked in a fresh interpreter: every module of ``scaleprotoseg_torch``
and the ``chip_smoke.py`` script are imported, then ``sys.modules`` must
hold no ``jax``/``flax`` module, nothing of ``scaleprotoseg_tpu``, and
none of ``cv2``, ``grain``, ``PIL`` or ``tifffile``, which the GPU
machine does not have.  And no line of the port's sources or of
``chip_smoke.py`` imports any of them, not even inside a function.
"""

import os
import re
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
                                    "scaleprotoseg_tpu", "cv2", "grain",
                                    "PIL", "tifffile"))
missing = sorted({"scaleprotoseg_torch." + m for m in (
    "ops.simplex", "push.push", "models.group_init",
    "finetune_wandb_group", "push.artifacts", "find_nearest", "prune",
    "run_pruning", "train_wandb", "analysis.threshold_save", "eval_test",
    "imageio", "helpers", "native", "data.jitter",
    "data.worker_loader", "ops.gradconv", "profiling", "codecs",
    "data.preprocess", "data.preprocess_cityscapes",
    "data.preprocess_part_pascal")} - set(names))
print(len(names), bad, missing)
sys.exit(1 if bad or missing or len(names) < 20 else 0)
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


_IMPORT = re.compile(r"^\s*(?:import|from)\s+(PIL|cv2|tifffile|jax|jaxlib|"
                     r"flax|scaleprotoseg_tpu)\b", re.M)


def test_no_source_line_imports_pil_cv2_tifffile_or_jax():
    """Lazy imports inside functions count too: ``serve`` once decoded
    ``.png`` / ``.jpg`` inputs and wrote its PNGs through PIL there."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "scaleprotoseg_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            for m in _IMPORT.finditer(f.read()):
                bad.append(f"{os.path.relpath(path, REPO)}: {m.group(0)}")
    assert len(files) > 40
    assert not bad, bad
