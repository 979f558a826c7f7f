"""The trainer CLI on the process-worker loader, with color jitter, on the
CPU.

``train_wandb_multiscale.main`` at tiny depth (the joint phase alone, 4
micro-steps at ``iter_size`` 2, a validation every 2, ``det_seed``,
jitter on) with ``loader_backend = 'grain_processes'``, stopped by the
preemption guard after micro-step 3 (mid-accumulation), exits 143;
relaunched, it ends bit-equal to the same run made straight on 'threads'
(the two backends sample one stream): every checkpoint and metrics row.

With jitter off, native and numpy augmentation give the same run.
"""

import shutil

import pytest

from scaleprotoseg_torch import train_wandb_multiscale as trainer_cli
from scaleprotoseg_torch.train import preemption
from e2e_utils import build_synthetic_dataset
from test_torch_resume import _StopAt, _few_threads, _same_runs  # noqa: F401
from test_torch_train_step import TINY

GIN = [line for line in TINY if "steps" not in line and
       "iter_size" not in line] + [
    "train.warmup_steps = 0", "train.joint_steps = 4",
    "train.finetune_steps = 0", "train.push_proto = False",
    "PatchClassificationModuleMultiScale.iter_size = 2",
    "Trainer.val_check_interval = 2",
    "PatchClassificationDataset.det_seed = 4"]


@pytest.fixture
def workdir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _run(workdir, name, extra, stop_at=None, monkeypatch=None):
    root = workdir / "data"
    if not root.exists():
        build_synthetic_dataset(str(root), n_train=4, n_val=2, size=48)
    argv = ["scaleproto_cityscapes", name, "--device", "cpu",
            "--data-root", str(root), "--results-root",
            str(workdir / "results")]
    for line in GIN + extra:
        argv += ["--gin", line]
    monkeypatch.setattr(preemption, "_guard", _StopAt(stop_at))
    return trainer_cli.main(argv)


def test_processes_with_jitter_resume_onto_the_threads_run(workdir,
                                                         monkeypatch):
    """Stopped after micro-step 3 (mid-accumulation) on worker processes,
    exit 143, relaunched: every checkpoint and metrics row equal to the
    straight run on threads, so the backends are interchangeable and the
    worker loader resumes exactly."""
    jitter = ["PatchClassificationDataset.jitter = True"]
    procs = ["PatchClassificationDataModule.loader_backend = "
             "'grain_processes'"]
    threads = _run(workdir, "threads", jitter, monkeypatch=monkeypatch)
    with pytest.raises(SystemExit) as exc:
        _run(workdir, "killed", jitter + procs, stop_at=3,
             monkeypatch=monkeypatch)
    assert exc.value.code == 143
    relaunched = _run(workdir, "killed", jitter + procs,
                      monkeypatch=monkeypatch)
    assert relaunched["phases"][1].resumed_at == 3
    assert relaunched["phases"][1].losses == \
        threads["phases"][1].losses[3:]
    ckpts = _same_runs({"straight": workdir / "results" / "threads",
                        "killed": workdir / "results" / "killed"})
    assert "nopush_last.pth" in ckpts


def test_native_and_numpy_runs_are_equal(workdir, monkeypatch):
    native = _run(workdir, "native", [], monkeypatch=monkeypatch)
    monkeypatch.setenv("SPS_NATIVE_AUG", "0")
    numpy = _run(workdir, "numpy", [], monkeypatch=monkeypatch)
    assert numpy["phases"][1].losses == native["phases"][1].losses
    _same_runs({"straight": workdir / "results" / "native",
                "killed": workdir / "results" / "numpy"})
