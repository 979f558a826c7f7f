"""The process-worker loader (``data/worker_loader.py``) and the
``loader_backend`` dispatch.

- ``WorkerDataLoader`` yields the threaded ``DataLoader``'s stream bit
  for bit with a jittered ``det_seed`` dataset: over three epochs, and
  after ``fast_forward(k)`` for several k, on one live loader whose
  persistent workers take each new epoch.
- An epoch leaves the parent's global torch RNG state as it was.
- ``make_loaders`` runs 'threads' and 'grain' on the threaded loader
  (logging the mapping for 'grain') and 'grain_processes' on worker
  processes, with the val split ``is_eval``; the JAX package's
  ``make_loaders`` accepts the same bindings.
- A SIGTERM sent to a loading process's group reaches that process
  alone: its workers go on serving (8 batches more, past those in flight
  and an epoch boundary), it exits 143, and no worker outlives it.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from scaleprotoseg_tpu import cli_common as jcli
from scaleprotoseg_tpu import configlib as jconfig
from scaleprotoseg_torch import cli_common
from scaleprotoseg_torch.configlib import parse_config
from scaleprotoseg_torch.data.dataset import \
    PatchClassificationDataset as TDataset
from scaleprotoseg_torch.data.loader import DataLoader
from scaleprotoseg_torch.data.worker_loader import WorkerDataLoader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(data_type="cityscapes", mean=[0.485, 0.456, 0.406],
          std=[0.229, 0.224, 0.225], image_margin_size=0,
          window_size=(33, 41), scales=(0.5, 1.5), jitter=True, det_seed=9)
BINDINGS = """
PatchClassificationDataset.data_type = 'cityscapes'
PatchClassificationDataset.image_margin_size = 0
PatchClassificationDataset.mean = [0.485, 0.456, 0.406]
PatchClassificationDataset.std = [0.229, 0.224, 0.225]
PatchClassificationDataset.scales = (0.5, 1.5)
PatchClassificationDataset.window_size = (33, 41)
PatchClassificationDataset.jitter = True
PatchClassificationDataModule.dataloader_n_jobs = 2
"""


@pytest.fixture(scope="module")
def city_root(tmp_path_factory):
    """7 train and 2 val images of about 64 x 128, labels 0-34."""
    root = tmp_path_factory.mktemp("city")
    rng = np.random.default_rng(13)
    index = {}
    for split, n in (("train", 7), ("val", 2)):
        os.makedirs(root / "annotations" / split)
        os.makedirs(root / "img_with_margin_0" / split)
        index[split] = []
        for i in range(n):
            h, w = 60 + 3 * i, 110 + 5 * i
            name = f"{split}{i}"
            index[split].append(name)
            np.save(root / "annotations" / split / f"{name}.npy",
                    rng.integers(0, 35, (h, w)).astype(np.uint8))
            np.save(root / "img_with_margin_0" / split / f"{name}.npy",
                    rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    with open(root / "all_images.json", "w") as f:
        json.dump(index, f)
    return str(root)


def _loader(cls, root):
    return cls(TDataset("train", root=root, **KW), 2, shuffle=True, seed=4,
               num_workers=2)


def _draw(loader, n):
    out = []
    while len(out) < n:
        for batch in loader:
            out.append(batch)
            if len(out) == n:
                break
    return out


@pytest.fixture(scope="module")
def threaded_stream(city_root):
    """Three epochs (4 batches each, the last ragged) of the threaded
    loader, and a live worker loader."""
    stream = _draw(_loader(DataLoader, city_root), 16)
    return stream, _loader(WorkerDataLoader, city_root)


def _assert_same(got, want):
    assert len(got) == len(want)
    for (xg, yg), (xw, yw) in zip(got, want):
        assert xg.dtype == np.float32 and yg.dtype == np.int32
        np.testing.assert_array_equal(xg, xw)
        np.testing.assert_array_equal(yg, yw)


@pytest.mark.parametrize("k", [0, 3, 4, 9])
def test_worker_stream_equals_threads(threaded_stream, k):
    """After ``fast_forward(k)`` the worker loader yields batch k onwards
    of the threaded stream, across epoch boundaries; the parent's torch
    RNG state is untouched."""
    want, loader = threaded_stream
    state = torch.get_rng_state()
    loader.fast_forward(k)
    _assert_same(_draw(loader, 7), want[k:k + 7])
    assert torch.equal(torch.get_rng_state(), state)


def test_make_loaders_dispatch_and_logs(city_root):
    lines = []
    loaders = {}
    for backend in ("threads", "grain", "grain_processes"):
        bindings = parse_config(
            BINDINGS + "PatchClassificationDataModule.loader_backend = "
            f"'{backend}'\nPatchClassificationDataset.det_seed = 9\n")
        loaders[backend] = cli_common.make_loaders(
            bindings, 2, seed=4, data_root=city_root, log=lines.append)
    assert type(loaders["threads"][0]) is DataLoader
    assert type(loaders["grain"][0]) is DataLoader
    assert type(loaders["grain_processes"][1]) is WorkerDataLoader
    assert sum("'grain'" in ln and "threaded loader" in ln
               for ln in lines) == 1
    assert sum("augmentation numpy+jitter" in ln for ln in lines) == 3
    assert sum("augmentation native" in ln for ln in lines) == 3
    tl, vl = loaders["grain_processes"]
    assert tl.dataset.jitter and not tl.dataset.is_eval
    assert vl.dataset.is_eval and vl.dataset.augmentation == "native"
    # one epoch of the val split through workers: the threads' batches
    _assert_same(list(vl), list(loaders["threads"][1]))


def test_jax_make_loaders_accepts_the_bindings(city_root):
    jconfig.clear_config()
    try:
        for backend in ("threads", "grain", "grain_processes"):
            jconfig.parse_config(
                BINDINGS + "PatchClassificationDataModule.loader_backend = "
                f"'{backend}'\n")
            tl, vl = jcli.make_loaders(2, num_workers=2,
                                       data_root=city_root)
            assert len(tl) == 4 and len(vl) == 1
            assert getattr(tl, "use_processes", False) == \
                (backend == "grain_processes")
            jconfig.clear_config()
    finally:
        jconfig.clear_config()


_LOADING = r"""
import os, sys, time
import numpy as np
from scaleprotoseg_torch.data.worker_loader import WorkerDataLoader
from scaleprotoseg_torch.train.preemption import Preempted, get_guard


class Items:
    epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return 12

    def __getitem__(self, i):
        time.sleep(0.02)
        return np.array([i, self.epoch, os.getpid()]), np.array([i])


if __name__ == "__main__":
    guard = get_guard()
    loader = WorkerDataLoader(Items(), 2, shuffle=True, seed=1,
                              num_workers=2)
    n, stop_at = 0, None
    while True:
        for x, _ in loader:
            n += 1
            print("batch", n, "from", sorted(set(x[:, 2].tolist())),
                  flush=True)
            # past the batches in flight and an epoch boundary
            if guard.should_stop(n) and stop_at is None:
                stop_at = n + 8
            if n == stop_at:
                raise Preempted(n)
"""


def _children(pid):
    """(pid, command line) of the live processes whose parent is ``pid``."""
    out = []
    for d in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{d}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{d}/cmdline") as f:
                cmd = f.read().replace("\0", " ")
        except OSError:
            continue
        if int(ppid) == pid and state != "Z":
            out.append((int(d), cmd))
    return out


def _alive(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def test_group_sigterm_reaches_the_loading_process_alone(tmp_path):
    script = tmp_path / "loading.py"
    script.write_text(_LOADING)
    out_path = tmp_path / "out.txt"
    env = {**os.environ, "PYTHONPATH": REPO}
    with open(out_path, "w") as out:
        proc = subprocess.Popen([sys.executable, str(script)], env=env,
                                stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            deadline = time.time() + 120
            while out_path.read_text().count("batch") < 8:
                assert proc.poll() is None and time.time() < deadline, \
                    out_path.read_text()
                time.sleep(0.05)
            workers = [p for p, cmd in _children(proc.pid)
                       if "spawn_main" in cmd]
            n_before = out_path.read_text().count("batch")
            os.killpg(proc.pid, signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = out_path.read_text()
    assert rc == 143, text
    assert len(workers) == 2
    # the signal did not stop the workers: 8 batches came after it (more
    # than are in flight, and a new epoch), each read in a worker
    assert text.count("batch") >= n_before + 8
    froms = {ln.split("from", 1)[1].strip() for ln in text.splitlines()
             if ln.startswith("batch")}
    assert froms <= {f"[{p}]" for p in workers}
    assert "Traceback" not in text
    assert not [p for p in workers if _alive(p)]
