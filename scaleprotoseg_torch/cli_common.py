"""Shared plumbing of the training entry points: config resolution and
overrides, the GPU recipe, seeding, the run directory and the loaders
(training, validation and prototype push).

A config is a name in the port's ``configs/`` directory
(``scaleproto_cityscapes``) or a path.  ``--gin 'name.param = value'``
lines override it, later ones winning; ``--gpu-recipe`` adds
``GPU_RECIPE_BINDINGS`` first.  A run directory is
``<results>/<experiment>/`` with ``checkpoints/`` and the config and its
overrides as ``config.gin`` (what ``model_loading.load_model`` reads
back).
"""

from __future__ import annotations

import os
import random
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from scaleprotoseg_torch import configlib
from scaleprotoseg_torch.configlib import Bindings, query
from scaleprotoseg_torch.data.dataset import PatchClassificationDataset
from scaleprotoseg_torch.data.loader import DataLoader
from scaleprotoseg_torch.data.worker_loader import WorkerDataLoader

CONFIGS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs")

# bf16 convs and add-on, and the ASPP through K2's kernels
GPU_RECIPE_BINDINGS = (
    "train.compute_dtype = 'bfloat16'",
    "train.fast_aspp = True",
)


def resolve_config(config_path: str) -> str:
    candidates = [config_path,
                  os.path.join(CONFIGS_DIR, config_path + ".gin"),
                  os.path.join(CONFIGS_DIR, config_path)]
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise FileNotFoundError(
        f"Config {config_path!r} not found (searched {candidates})")


def load_config(config_path: str) -> Tuple[str, Bindings]:
    """(resolved path, bindings) of a config name or path."""
    path = resolve_config(config_path)
    return path, configlib.parse_config_file(path)


def apply_overrides(bindings: Bindings,
                    overrides: Optional[Iterable[str]] = None,
                    gpu_recipe: bool = False, log=None) -> list:
    """Merge ``--gin`` binding lines (and the GPU recipe's, first) into
    ``bindings`` in place; returns the lines applied."""
    lines = list(GPU_RECIPE_BINDINGS if gpu_recipe else ()) + \
        list(overrides or [])
    for line in lines:
        for name, params in configlib.parse_config(line).items():
            bindings.setdefault(name, {}).update(params)
    if lines and log:
        log(f"CLI gin overrides: {'; '.join(lines)}")
    return lines


def add_override_args(parser) -> None:
    """The shared ``--gin``, ``--gpu-recipe`` and ``--device`` flags."""
    parser.add_argument(
        "--gin", action="append", default=None, metavar="BINDING",
        help="extra gin binding, e.g. --gin \"train.warmup_steps = 10\" "
             "(repeatable; overrides the config file)")
    parser.add_argument(
        "--gpu-recipe", action="store_true",
        help="bf16 convs and add-on with float32 parameters, and the ASPP "
             "through the K2 forward and backward kernels")
    parser.add_argument(
        "--device", default=None,
        help="torch device (default cuda, an error without one; 'cpu' "
             "runs the plain versions of the kernels)")


def seed_everything(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def setup_run_dir(results_root: str, experiment_name: str,
                  config_file: str, overrides: Iterable[str] = ()) -> str:
    """The run directory, with the config and the override lines after
    it as ``config.gin``, so that ``load_model`` rebuilds the model the
    run trained."""
    run = os.path.join(results_root, experiment_name)
    os.makedirs(os.path.join(run, "checkpoints"), exist_ok=True)
    with open(config_file) as f:
        text = f.read()
    lines = list(overrides)
    if lines:
        text += "\n# command-line overrides\n" + "\n".join(lines) + "\n"
    with open(os.path.join(run, "config.gin"), "w") as f:
        f.write(text)
    return run


def train_hparams(bindings: Bindings) -> dict:
    q = lambda p, d: query(bindings, "train", p, d)  # noqa: E731
    return dict(
        random_seed=q("random_seed", 20220227),
        warmup_steps=q("warmup_steps", 0),
        joint_steps=q("joint_steps", 0),
        finetune_steps=q("finetune_steps", 0),
        warmup_batch_size=q("warmup_batch_size", 2),
        joint_batch_size=q("joint_batch_size", 2),
        early_stopping_patience_last_layer=q(
            "early_stopping_patience_last_layer", 100),
        start_checkpoint=q("start_checkpoint", ""),
        # read as the JAX package reads it, which then never uses it
        load_coco=q("load_coco", False),
        push_proto=q("push_proto", True),
        data_type=q("data_type", query(bindings,
                                       "PatchClassificationDataModule",
                                       "data_type", None)),
    )


def _dataset_kwargs(bindings: Bindings, data_root: Optional[str]) -> dict:
    q = lambda p, d=None: query(bindings, "PatchClassificationDataset",  # noqa: E731
                                p, d)
    return dict(data_type=q("data_type"), mean=q("mean"), std=q("std"),
                image_margin_size=q("image_margin_size", 0),
                window_size=q("window_size"), scales=q("scales", (1.0,)),
                jitter=q("jitter", False), root=data_root,
                det_seed=q("det_seed"))


def _num_workers(bindings: Bindings, num_workers: Optional[int]) -> int:
    if num_workers is not None:
        return num_workers
    return query(bindings, "PatchClassificationDataModule",
                 "dataloader_n_jobs", 8)


LOADER_BACKENDS = {"threads": DataLoader, "grain": DataLoader,
                   "grain_processes": WorkerDataLoader}


def make_loaders(bindings: Bindings, batch_size: int,
                 num_workers: Optional[int] = None, seed: int = 0,
                 data_root: Optional[str] = None, log=print):
    """(train_loader, val_loader) per the dataset bindings; the val
    dataset is ``is_eval`` (never jittered).
    ``PatchClassificationDataModule.loader_backend``: 'threads' (the
    default) is the threaded ``DataLoader``, 'grain_processes' the
    process-worker ``WorkerDataLoader``; 'grain', the JAX package's grain
    engine on threads, which yields the threaded loader's batches, runs
    the threaded ``DataLoader`` (grain is no dependency of the port).
    ``log`` gets one line per dataset: the backend and the augmentation
    path its items take."""
    backend = query(bindings, "PatchClassificationDataModule",
                    "loader_backend", "threads")
    if backend not in LOADER_BACKENDS:
        raise ValueError(f"unknown loader_backend {backend!r} "
                         "(threads | grain | grain_processes)")
    cls = LOADER_BACKENDS[backend]
    if backend == "grain":
        log("loader_backend 'grain': the port runs its threaded loader, "
            "which yields the same batches as the JAX package's grain "
            "thread engine")
    num_workers = _num_workers(bindings, num_workers)
    train_key = query(bindings, "PatchClassificationDataModule", "train_key",
                      "train")
    kw = _dataset_kwargs(bindings, data_root)
    train_ds = PatchClassificationDataset(train_key, **kw)
    val_ds = PatchClassificationDataset("val", is_eval=True, **kw)
    for name, ds in (("train", train_ds), ("val", val_ds)):
        log(f"{name} loader: {cls.__name__} ({backend}), {num_workers} "
            f"workers, augmentation {ds.augmentation}")
    return (cls(train_ds, batch_size, shuffle=True,
                num_workers=num_workers, seed=seed),
            cls(val_ds, batch_size, shuffle=False,
                num_workers=num_workers, seed=seed))


def make_push_loader(bindings: Bindings, batch_size: int = 1,
                     num_workers: Optional[int] = None,
                     data_root: Optional[str] = None) -> DataLoader:
    """Prototype push's loader: the train split at full resolution,
    normalized and unaugmented (never jittered), in a fixed order
    (re-iterable: push reads it twice)."""
    ds = PatchClassificationDataset("train", push_prototypes=True,
                                    **_dataset_kwargs(bindings, data_root))
    return DataLoader(ds, batch_size, shuffle=False,
                      num_workers=_num_workers(bindings, num_workers))


def run_phases(trainer, bindings: Bindings, hp: dict, phases: Iterable[int],
               results: dict, num_workers: Optional[int] = None,
               data_root: Optional[str] = None) -> dict:
    """Run ``phases`` (0 warm-up, 1 joint, 2 last layer with early
    stopping) of ``trainer`` in order, each on fresh loaders seeded
    ``random_seed + phase``; a phase of 0 steps is skipped.  ``results``
    ({phase: PhaseResult}) gathers them, and the global step goes on from
    the phases already in it."""
    steps = {0: hp["warmup_steps"], 1: hp["joint_steps"],
             2: hp["finetune_steps"]}
    batch = {0: hp["warmup_batch_size"], 1: hp["joint_batch_size"],
             2: hp["joint_batch_size"]}
    val_check = query(bindings, "Trainer", "val_check_interval", None)
    for phase in phases:
        if steps[phase] <= 0:
            continue
        tl, vl = make_loaders(bindings, batch[phase], num_workers=num_workers,
                              seed=hp["random_seed"] + phase,
                              data_root=data_root, log=trainer.log)
        results[phase] = trainer.run_phase(
            phase, steps[phase], tl, vl,
            early_stopping_patience=(
                hp["early_stopping_patience_last_layer"] if phase == 2
                else None),
            val_every_steps=val_check,
            global_step0=sum(r.steps_done for r in results.values()))
    return results
