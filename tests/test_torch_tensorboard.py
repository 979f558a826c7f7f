"""The TensorBoard sink of the port against the JAX package's.

Where ``torch.utils.tensorboard`` imports: the same rows logged through
both packages' ``MetricsLogger`` with ``make_external_sinks`` write the
same tags, steps and values to ``<run>/logs/tb`` (read back with
``EventAccumulator``) and the same ``hparams`` text; a second logger on
the same run (a relaunch) appends to the same directory.  Where it does
not import, the sink is skipped and one log line says it is disabled;
that line is also checked with the import made to fail.  W&B stays
refused by name.
"""

import builtins
import json
import os
import time

import pytest

from scaleprotoseg_tpu.train import metrics as jmetrics
from scaleprotoseg_torch.train import metrics as tmetrics

ROWS = [({"train_loss": 1.25, "val_accuracy": 0.5, "training_stage": 0.0},
         5),
        ({"train_loss": 0.75, "val_accuracy": 0.625, "training_stage": 1.0},
         10)]
HPARAMS = {"train.joint_steps": 10, "PatchClassificationDataset.scales":
           (0.5, 1.5)}


def _read(tb_dir: str):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    acc = EventAccumulator(tb_dir, size_guidance={"scalars": 0})
    acc.Reload()
    scalars = {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
               for tag in acc.Tags()["scalars"]}
    return scalars, acc.Tags()["tensors"]


def _log(metrics_mod, run: str, rows, logs):
    logger = metrics_mod.MetricsLogger(
        run, sinks=metrics_mod.make_external_sinks(run, log=logs.append)
        if metrics_mod is tmetrics else metrics_mod.make_external_sinks(
            run, "exp", log=logs.append))
    logger.log_hyperparams(HPARAMS)
    for row, step in rows:
        logger.log(row, step=step)
    logger.finish()
    return logger


def test_tensorboard_sink_matches_jax(tmp_path):
    pytest.importorskip("torch.utils.tensorboard")
    pytest.importorskip("tensorboard.backend.event_processing")
    tlogs, jlogs = [], []
    trun, jrun = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _log(tmetrics, trun, ROWS, tlogs).sinks
    _log(jmetrics, jrun, ROWS, jlogs)
    assert not tlogs and not jlogs
    got, got_tensors = _read(os.path.join(trun, "logs", "tb"))
    want, want_tensors = _read(os.path.join(jrun, "logs", "tb"))
    assert got == want
    assert set(got) == {"train_loss", "val_accuracy", "training_stage",
                        "step"}
    assert got["train_loss"] == [(5, 1.25), (10, 0.75)]
    assert got_tensors == want_tensors and \
        any("hparams" in t for t in got_tensors)

    # a relaunch appends to the same event directory.  A relaunch is a
    # later process, and its event file (named by the second, the host,
    # the pid and a per-process counter) sorts after the first one; here
    # both are made in one process, where within one second the counter
    # decides and "10" sorts before "9": start it in the next second
    time.sleep(1.0 - time.time() % 1.0 + 0.01)
    _log(tmetrics, trun, [({"train_loss": 0.5}, 15)], tlogs)
    again, _ = _read(os.path.join(trun, "logs", "tb"))
    assert again["train_loss"] == [(5, 1.25), (10, 0.75), (15, 0.5)]


def test_tensorboard_disabled_line(tmp_path, monkeypatch):
    """Without ``torch.utils.tensorboard`` the run goes on with no sink
    and one log line; asking for W&B is refused by name."""
    real = builtins.__import__

    def no_tensorboard(name, *args, **kwargs):
        if name.startswith("torch.utils.tensorboard"):
            raise ImportError("No module named 'tensorboard'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tensorboard)
    logs = []
    run = str(tmp_path / "run")
    sinks = tmetrics.make_external_sinks(run, log=logs.append)
    assert sinks == [] and len(logs) == 1
    assert logs[0].startswith("TensorBoard logging disabled")
    logger = tmetrics.MetricsLogger(run, sinks=sinks)
    logger.log_hyperparams(HPARAMS)
    logger.log(*ROWS[0])
    logger.finish()
    with open(os.path.join(run, "metrics.jsonl")) as f:
        assert json.loads(f.readline())["train_loss"] == 1.25
    assert not os.path.exists(os.path.join(run, "logs", "tb"))
    monkeypatch.setenv("USE_WANDB", "1")
    with pytest.raises(NotImplementedError, match="W&B"):
        tmetrics.MetricsLogger(run, sinks=sinks)
