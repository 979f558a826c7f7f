"""Mid-phase resume and preemption of the port's trainer, bit for bit.

The counterparts of the JAX package's ``tests/test_resume.py`` and
``tests/test_preemption.py``, at tiny depth on the CPU:

- ``checkpoints/state_io``: an asynchronous save overwritten in flight,
  the restore in place, the refusal of another model's state by name;
- a phase of 6 micro-steps (``iter_size`` 2, a validation every 2)
  against 4 steps plus a fresh trainer resuming to 6: every tensor of
  the train state (parameters, Adam moments and steps, the accumulated
  gradient and the device counters), ``best_acc``, the losses and the
  metrics rows bit-equal;
- SIGTERM after micro-step 3 (mid-accumulation) and after micro-step 4 (a
  validation): ``Preempted`` with code 143 and a committed state, then a
  relaunch equal to the straight run, bit for bit;
- the trainer CLI preempted in its joint phase and relaunched: every
  checkpoint, push's dedup table and the metrics rows equal to a run never
  stopped; the group CLI (``finetune_wandb_group``) from that run's
  ``push_final`` likewise, stopped in its warm-up;
- the guard chains the SIGTERM handler it replaces;
- the JAX package's train state carried into the port mid-accumulation
  (``checkpoints.convert.train_state_from_jax``): 3 JAX micro-steps at
  ``iter_size`` 2, then 3 of the port, against 6 JAX micro-steps at
  ``test_torch_train_step``'s tolerance (losses within 1e-4, Adam's
  moments within 1e-4 of their largest entry, parameters within 1e-4 on
  at least 99.9% of every tensor: Adam's sign-like update flips where
  ``g`` is a float32 rounding from 0), counters exact.
"""

import csv
import json
import os
import shutil
import signal
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scaleprotoseg_tpu.train import optim as joptim
from scaleprotoseg_tpu.train import steps as jsteps
from scaleprotoseg_tpu.train.state import TrainState as JState
from scaleprotoseg_torch import finetune_wandb_group as group_cli
from scaleprotoseg_torch import train_wandb_multiscale as trainer_cli
from scaleprotoseg_torch.checkpoints import state_io
from scaleprotoseg_torch.checkpoints.convert import train_state_from_jax
from scaleprotoseg_torch.data.loader import DataLoader
from scaleprotoseg_torch.models.deeplab import DeepLabV2
from scaleprotoseg_torch.models.ppnet import PPNet
from scaleprotoseg_torch.spec import ProtoSpec
from scaleprotoseg_torch.train import preemption
from scaleprotoseg_torch.train.metrics import MetricsLogger
from scaleprotoseg_torch.train.optim import OptimGroup, PhaseOptimizer
from scaleprotoseg_torch.train.runner import PhaseTrainer
from scaleprotoseg_torch.train.state import TrainState
from scaleprotoseg_torch.train.steps import LossWeights, make_train_step
from e2e_utils import build_synthetic_dataset
from test_torch_train_step import HP, TINY, WEIGHTS, _pair
from torch_parity import port_spec, to_numpy_tree

SPEC = ProtoSpec.equal_allocation(24, 8, 3, 4)
HPARAMS = dict(
    weights=LossWeights(kld=0.25), hp=dict(
        warm_lr_add_on=1e-3, warm_lr_protos=1e-3, warm_wd=5e-4,
        joint_lr_features=1e-4, joint_lr_add_on=1e-3, joint_lr_protos=1e-3,
        joint_wd=5e-4, last_layer_lr=1e-3, warm_lr_group=1e-3,
        joint_lr_group=1e-3),
    poly_lr_power=0.9, iter_size=2, ignore_void_class=True,
    joint_no_proto=False, joint_last=True)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the models here are tiny, and the test run
    shares the host's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def workdir(tmp_path):
    """``tmp_path``, removed after the test: each run directory holds
    train states of a few hundred MB."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture
def fresh_guard():
    """The process's guard and SIGTERM handler restored after the test."""
    prev = signal.getsignal(signal.SIGTERM)
    preemption._guard = None
    yield
    preemption._guard = None
    signal.signal(signal.SIGTERM, prev)


@pytest.fixture(scope="module")
def init_state():
    torch.manual_seed(0)
    return {k: v.clone() for k, v in _model().state_dict().items()}


def _model(init=None):
    model = PPNet(DeepLabV2(n_out=8, n_blocks=(1, 1, 1, 1),
                            aspp_mode="concat"), SPEC,
                  generator=torch.Generator().manual_seed(0))
    if init is not None:
        model.load_state_dict(init)
    return model


class _DetDataset:
    """Items are a function of (epoch, index) alone, as a ``det_seed``
    dataset's are."""

    def __init__(self, n):
        self.n, self.epoch = n, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(1000 * (self.epoch + 1) + i)
        return (rng.standard_normal((33, 33, 3)).astype(np.float32),
                rng.integers(0, 4, (33, 33)).astype(np.int32))


def _loaders():
    return (DataLoader(_DetDataset(8), 2, shuffle=True, seed=5,
                       num_workers=2),
            DataLoader(_DetDataset(4), 2, shuffle=False, seed=7,
                       num_workers=2))


def _trainer(d, init):
    return PhaseTrainer(_model(init), SPEC, "multiscale", str(d), HPARAMS,
                        {}, torch.device("cpu"),
                        logger=MetricsLogger(str(d)), log=lambda *a: None)


def _run(d, init, phase, max_steps, val_every, train_loader=None,
         resume=True):
    tl, vl = _loaders()
    tr = _trainer(d, init)
    res = tr.run_phase(phase, max_steps, train_loader or tl, vl,
                       val_every_steps=val_every, resume=resume)
    return tr, res


def _state(d, stage):
    return torch.load(os.path.join(d, "checkpoints", f"{stage}_state",
                                   "state.pt"), weights_only=True)


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def _rows(d):
    with open(os.path.join(d, "metrics.csv"), newline="") as f:
        return [{k: v for k, v in r.items() if k != "time"}
                for r in csv.DictReader(f)]


# ---------------------------------------------------------------------------
# the state on disk
# ---------------------------------------------------------------------------
def _linear_state(out=3):
    torch.manual_seed(1)
    model = torch.nn.Linear(4, out)
    opt = PhaseOptimizer(model.named_parameters(),
                         {"features_conv": OptimGroup(1e-2, 1e-3)},
                         iter_size=2, guard_nonfinite=5)
    return TrainState(model, opt)


def _micro_step(state, seed):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (5, 4)).astype(np.float32))
    state.model(x).square().sum().backward()
    state.optimizer.step()
    state.step += 1


def test_state_io_round_trip_in_flight_and_refusal(workdir):
    path = str(workdir / "s")
    state = _linear_state()
    for i in range(3):
        _micro_step(state, i)
    state_io.save_train_state(path, state)            # in flight
    _micro_step(state, 3)
    state.extra = {"note": 1.5}
    state_io.save_train_state(path, state)            # waits, overwrites
    state_io.wait_for_checkpoints()
    stats = state_io.last_save_stats()
    assert stats["step"] == 4 and stats["bytes"] > 0 and \
        stats["commit_s"] >= 0
    with open(os.path.join(path, "meta.json")) as f:
        assert json.load(f)["step"] == 4

    template = _linear_state()
    acc, weight = template.optimizer._acc, template.model.weight
    version = weight._version
    assert state_io.restore_train_state(path, template) is template
    assert template.step == 4 and template.extra == {"note": 1.5}
    _assert_trees_equal(template.state_dict(), state.state_dict())
    # in place: the gradient views and the parameters are the same tensors
    assert template.optimizer._acc is acc and template.model.weight is weight
    assert weight._version > version
    # both continue alike
    _micro_step(state, 4)
    _micro_step(template, 4)
    _assert_trees_equal(template.state_dict(), state.state_dict())

    with pytest.raises(ValueError, match="weight"):
        state_io.restore_train_state(path, _linear_state(out=2))
    assert state_io.restore_train_state(str(workdir / "none"),
                                        _linear_state()) is None
    # a crash between the commit's two renames leaves the old state aside
    os.replace(path, path + ".old")
    assert state_io.restore_train_state(path, _linear_state()).step == 4


# ---------------------------------------------------------------------------
# resume and preemption of a phase
# ---------------------------------------------------------------------------
def test_exact_resume_trajectory(workdir, init_state, fresh_guard):
    """6 micro-steps straight against 4, then a fresh trainer (and fresh
    loaders) resuming to 6; warm-up phase, ``iter_size`` 2."""
    _, full = _run(workdir / "straight", init_state, 0, 6, 2)
    _, part = _run(workdir / "killed", init_state, 0, 4, 2)
    tr, rest = _run(workdir / "killed", init_state, 0, 6, 2)
    assert rest.resumed_at == 4 and rest.steps_done == 6
    assert part.losses + rest.losses == full.losses
    assert rest.best_acc == full.best_acc > 0
    _assert_trees_equal(_state(workdir / "killed", "warmup"),
                        _state(workdir / "straight", "warmup"))
    assert _rows(workdir / "killed") == _rows(workdir / "straight")
    assert all(float(r["train_loss"]) > 0
               for r in _rows(workdir / "straight"))
    # resume=False starts the phase afresh beside the saved state
    _, again = _run(workdir / "killed", init_state, 0, 6, 2, resume=False)
    assert again.resumed_at == 0 and again.losses == full.losses


class _SigtermAt:
    """The loader's batches, with a SIGTERM to this process before batch
    index ``k`` (the runner then stops after micro-step k + 1)."""

    def __init__(self, inner, k):
        self.inner, self.k = inner, k
        self.batch_size = inner.batch_size

    def __len__(self):
        return len(self.inner)

    def fast_forward(self, n):
        self.inner.fast_forward(n)

    def __iter__(self):
        for i, batch in enumerate(self.inner):
            if i == self.k:
                os.kill(os.getpid(), signal.SIGTERM)
            yield batch


@pytest.mark.parametrize("k", [2, 3], ids=["mid_accumulation",
                                           "at_validation"])
def test_preempt_then_relaunch_matches_straight_run(workdir, init_state,
                                                    fresh_guard, k):
    """Joint phase (poly schedule), ``iter_size`` 2, a validation every
    4 of 6 micro-steps: SIGTERM, exit 143 after micro-step k + 1 with the
    state committed, and the relaunch ends on the straight run's bits."""
    _, full = _run(workdir / "straight", init_state, 1, 6, 4)
    kill = workdir / "killed"
    with pytest.raises(preemption.Preempted) as exc:
        _run(kill, init_state, 1, 6, 4,
             train_loader=_SigtermAt(_loaders()[0], k))
    assert exc.value.step == k + 1 and exc.value.code == 143
    saved = _state(kill, "nopush")
    assert saved["step"] == k + 1
    assert int(saved["optimizer"]["mini"]) == (k + 1) % 2
    preemption._guard = None            # the relaunched process's own
    _, rest = _run(kill, init_state, 1, 6, 4)
    assert rest.resumed_at == k + 1 and rest.steps_done == 6
    assert rest.losses == full.losses[k + 1:]
    assert rest.best_acc == full.best_acc
    _assert_trees_equal(_state(kill, "nopush"),
                        _state(workdir / "straight", "nopush"))
    assert _rows(kill) == _rows(workdir / "straight")


class _StopAt:
    """A guard that asks to stop at one global step."""

    def __init__(self, step):
        self.step = step

    def should_stop(self, step):
        return step == self.step


def _same_runs(runs):
    ckpts = sorted(f for f in os.listdir(runs["straight"] / "checkpoints")
                   if f.endswith(".pth"))
    for name in ckpts:
        _assert_trees_equal(
            torch.load(runs["killed"] / "checkpoints" / name),
            torch.load(runs["straight"] / "checkpoints" / name))
    assert _rows(runs["killed"]) == _rows(runs["straight"])
    return ckpts


def test_cli_preempted_and_relaunched_equals_straight(workdir, monkeypatch):
    """``train_wandb_multiscale.main`` on the CPU (push on, ``det_seed``,
    ``iter_size`` 2): stopped at global step 3 (joint micro-step 1), then
    relaunched with the same command; every checkpoint, the dedup table
    and the metrics rows equal a straight run's."""
    root = build_synthetic_dataset(str(workdir / "data"), n_train=4,
                                   n_val=2, size=48)
    gin = [line for line in TINY if "iter_size" not in line and
           "joint_steps" not in line and "finetune_steps" not in line] + [
        "train.joint_steps = 3", "train.finetune_steps = 2",
        "PatchClassificationModuleMultiScale.iter_size = 2",
        "PatchClassificationDataset.det_seed = 4",
        "Trainer.val_check_interval = 2"]

    def argv(name):
        out = ["scaleproto_cityscapes", name, "--device", "cpu",
               "--data-root", root, "--results-root",
               str(workdir / "results")]
        for line in gin:
            out += ["--gin", line]
        return out

    monkeypatch.setattr(preemption, "_guard", _StopAt(None))
    straight = trainer_cli.main(argv("straight"))
    monkeypatch.setattr(preemption, "_guard", _StopAt(3))
    with pytest.raises(SystemExit) as exc:
        trainer_cli.main(argv("killed"))
    assert exc.value.code == 143
    monkeypatch.setattr(preemption, "_guard", _StopAt(None))
    relaunched = trainer_cli.main(argv("killed"))
    assert relaunched["phases"][0].resumed_at == 2
    assert relaunched["phases"][1].resumed_at == 1
    assert relaunched["phases"][0].losses == []
    assert relaunched["phases"][1].losses == \
        straight["phases"][1].losses[1:]
    runs = {n: workdir / "results" / n for n in ("straight", "killed")}
    ckpts = _same_runs(runs)
    assert "push_final.pth" in ckpts and "push_last.pth" in ckpts
    with open(runs["straight"] / "prototypes" / "unique_prototypes.json") as f:
        want = json.load(f)
    with open(runs["killed"] / "prototypes" / "unique_prototypes.json") as f:
        assert json.load(f) == want
    shutil.rmtree(runs["killed"])

    # the group phase from that push_final, stopped at warm-up step 1
    group_gin = [line.replace("construct_PPNet.", "construct_PPNet_Group.")
                 for line in gin if "prototype_shape" not in line]

    def group_argv(name):
        out = ["group_scaleproto_cityscapes", "g_" + name, "--device", "cpu",
               "--start-checkpoint", straight["final"], "--data-root", root,
               "--results-root", str(workdir / "results")]
        for line in group_gin:
            out += ["--gin", line]
        return out

    monkeypatch.setattr(preemption, "_guard", _StopAt(None))
    group_cli.main(group_argv("straight"))
    monkeypatch.setattr(preemption, "_guard", _StopAt(1))
    with pytest.raises(SystemExit) as exc:
        group_cli.main(group_argv("killed"))
    assert exc.value.code == 143
    monkeypatch.setattr(preemption, "_guard", _StopAt(None))
    out = group_cli.main(group_argv("killed"))
    assert out["phases"][0].resumed_at == 1
    ckpts = _same_runs({n: workdir / "results" / f"g_{n}"
                        for n in ("straight", "killed")})
    assert "final-group.pth" in ckpts


def test_guard_chains_the_previous_handler(fresh_guard):
    seen = []
    signal.signal(signal.SIGTERM, lambda signum, frame: seen.append(signum))
    guard = preemption.get_guard(log=lambda *a: None)
    assert preemption.get_guard() is guard
    assert not guard.should_stop(0)
    os.kill(os.getpid(), signal.SIGTERM)
    assert guard.should_stop(1) and seen == [signal.SIGTERM]
    exc = preemption.Preempted(7)
    assert isinstance(exc, SystemExit) and exc.code == 143
    assert "step 7" in str(exc)
    # off the main thread no handler can be installed: it says so
    logged = []
    t = threading.Thread(target=lambda: preemption.PreemptionGuard(
        log=logged.append))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and "main thread" in logged[0]
    assert signal.getsignal(signal.SIGTERM) == guard._on_sigterm


# ---------------------------------------------------------------------------
# the JAX package's state, carried across mid-accumulation
# ---------------------------------------------------------------------------
def test_jax_train_state_carried_mid_accumulation():
    from test_torch_train_step import _batch

    model, spec, variables, tm = _pair()
    tspec = port_spec(spec)
    batches = [_batch(seed) for seed in range(6)]
    groups = joptim.phase_groups("multiscale", 1, HP)
    trainable, _ = joptim.partition_params(variables["params"], set(groups))
    tx = joptim.make_phase_optimizer(
        groups, joptim.label_params(trainable),
        schedule=joptim.poly_schedule(0.9, 10), iter_size=2,
        guard_nonfinite=50)
    jstate = JState.create(variables["params"], variables["batch_stats"],
                           tx.init(trainable))
    fn = jsteps.make_train_step(model, spec, tx, set(groups),
                                jsteps.LossWeights(**WEIGHTS), donate=False)
    jlosses, at3 = [], None
    for i, (x, y) in enumerate(batches):
        jstate, m = fn(jstate, jnp.asarray(x), jnp.asarray(y))
        jlosses.append(float(m["loss"]))
        if i == 2:
            at3 = jstate

    from scaleprotoseg_torch.train import optim as toptim
    from scaleprotoseg_torch.train import steps as tsteps
    opt = toptim.PhaseOptimizer(
        tm.named_parameters(), toptim.phase_groups("multiscale", 1, HP),
        schedule=toptim.poly_schedule(0.9, 10), iter_size=2,
        guard_nonfinite=50)
    state = TrainState(tm, opt)
    state.load_state_dict(train_state_from_jax(
        to_numpy_tree(at3.params), to_numpy_tree(at3.batch_stats),
        to_numpy_tree(at3.opt_state), int(at3.step), tspec, opt.names))
    assert state.step == 3 and int(opt._mini) == 1
    step = tsteps.make_train_step(tsteps.LossWeights(**WEIGHTS))
    for i, (x, y) in enumerate(batches[3:]):
        got = float(step(state, torch.from_numpy(x),
                         torch.from_numpy(y))["loss"])
        assert got == pytest.approx(jlosses[3 + i], rel=1e-4, abs=1e-4)

    want = train_state_from_jax(
        to_numpy_tree(jstate.params), to_numpy_tree(jstate.batch_stats),
        to_numpy_tree(jstate.opt_state), int(jstate.step), tspec, opt.names)
    have = state.state_dict()
    assert have["step"] == want["step"] == 6
    wo, ho = want["optimizer"], have["optimizer"]
    for key in ("mini", "streak", "updates"):
        assert float(ho[key]) == float(wo[key]), key
    assert float(wo["updates"]) == 3.0
    for name, hs, ws in zip(opt.names, ho["step"], wo["step"]):
        assert float(hs) == float(ws) == 3.0, name
    for key in ("exp_avg", "exp_avg_sq"):
        for name, h, w in zip(opt.names, ho[key], wo[key]):
            scale = float(w.abs().max())
            np.testing.assert_allclose(h.numpy(), w.numpy(), rtol=0,
                                       atol=1e-4 * scale,
                                       err_msg=f"{key} {name}")
    for name, w in want["model"].items():
        h = have["model"][name]
        if name in opt.names:
            close = (h - w).abs() <= 1e-4
            assert close.float().mean() >= 0.999, name
        else:
            assert torch.equal(h, w.to(h.dtype)), name
