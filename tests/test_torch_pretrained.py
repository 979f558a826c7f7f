"""The pretrained backbone of the port against the JAX package's.

- A seeded torchvision-layout ResNet state dict at the tiny flagship's
  blocks (``conv1``/``bn1``, ``layerN.M.convK``/``bnK``, ``downsample``,
  ``fc``, ``num_batches_tracked``), saved as ``.pth``: the JAX package's
  ``load_torch_backbone_into`` followed by ``ppnet_params_to_statedict``
  equals the port's ``load_torch_backbone_into`` model's ``state_dict()``
  exactly; ``fc`` is dropped, and a tensor of another shape is skipped in
  both with a "shape mismatch" log line.
- ``PRETRAINED_BACKBONE_CKPT`` from the port's own checkpoint stem copies
  its ``features.base.*`` tensors and nothing else; a JAX msgpack
  ``.ckpt`` and a pickled module are refused by name.
- The trainer CLI reads ``PRETRAINED_BACKBONE`` after building the model
  and before ``train.start_checkpoint``, and ``construct_PPNet.pretrained
  = True`` loads nothing and says so once.
"""

import os

import numpy as np
import pytest
import torch

from scaleprotoseg_tpu.checkpoints import torch_convert as jconvert
from scaleprotoseg_torch import configlib, train_wandb_multiscale
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     ppnet_params_to_statedict,
                                                     save_checkpoint,
                                                     synthetic_state_dict,
                                                     to_tensors)
from scaleprotoseg_torch.checkpoints.pretrained import (
    PREFIX, load_backbone_checkpoint_into, load_torch_backbone_into,
    torchvision_key_to_deeplab, torchvision_resnet_to_backbone)
from scaleprotoseg_torch.cli_common import CONFIGS_DIR
from e2e_utils import build_synthetic_dataset
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import jax_flagship, port_model, port_spec, to_numpy_tree
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

MISMATCHED = "layer2.0.conv2.weight"


def _torchvision_name(key: str) -> str:
    """The torchvision key of a DeepLabV2 reference name (the inverse of
    ``torchvision_key_to_deeplab``)."""
    parts = key.split(".")
    if parts[0] == "layer1":                     # the stem
        return {"conv": "conv1", "bn": "bn1"}[parts[2]] + "." + parts[-1]
    layer = int(parts[0][len("layer"):]) - 1
    block = int(parts[1][len("block"):]) - 1
    if parts[2] == "shortcut":
        sub = {"conv": 0, "bn": 1}[parts[3]]
        return f"layer{layer}.{block}.downsample.{sub}.{parts[-1]}"
    num = {"reduce": 1, "conv3x3": 2, "increase": 3}[parts[2]]
    return f"layer{layer}.{block}.{parts[3]}{num}.{parts[-1]}"


def torchvision_state_dict(model, seed: int = 7, mismatch: bool = False):
    """A seeded torchvision-layout state dict with the shapes of
    ``model``'s backbone (ASPP excluded), ``fc`` included; ``mismatch``
    gives ``MISMATCHED`` one more output channel."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, t in model.state_dict().items():
        if not key.startswith(PREFIX) or ".aspp." in key:
            continue
        name = _torchvision_name(key[len(PREFIX):])
        shape = tuple(t.shape)
        if name == MISMATCHED and mismatch:
            shape = (shape[0] + 1,) + shape[1:]
        if name.endswith("num_batches_tracked"):
            out[name] = torch.tensor(5)
        elif name.endswith("running_var"):
            out[name] = torch.from_numpy(
                rng.uniform(0.5, 1.5, shape).astype(np.float32))
        else:
            out[name] = torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))
    out["fc.weight"] = torch.from_numpy(
        rng.standard_normal((10, 2048)).astype(np.float32))
    out["fc.bias"] = torch.zeros(10)
    return out


@pytest.fixture(scope="module")
def flagship():
    model, spec, variables = jax_flagship(grouped=False, side=33, seed=3)
    return model, spec, variables


def test_key_map_matches_jax():
    for key in ("conv1.weight", "bn1.running_var", "layer1.0.conv1.weight",
                "layer3.22.bn3.bias", "layer4.0.downsample.0.weight",
                "layer4.0.downsample.1.running_mean", "fc.weight"):
        assert torchvision_key_to_deeplab(key) == \
            jconvert.torchvision_key_to_deeplab(key)


@pytest.mark.parametrize("mismatch", [False, True],
                         ids=["all", "one_shape_mismatched"])
def test_torchvision_backbone_matches_jax(flagship, tmp_path, mismatch):
    model, spec, variables = flagship
    tm = port_model(model, spec, variables)
    sd = torchvision_state_dict(tm, mismatch=mismatch)
    path = str(tmp_path / "resnet.pth")
    torch.save(sd, path)

    jlog, tlog = [], []
    loaded = jconvert.load_torch_backbone_into(
        {k: v for k, v in variables.items()}, path, log=jlog.append)
    want = ppnet_params_to_statedict(
        to_numpy_tree(loaded["params"]), to_numpy_tree(loaded["batch_stats"]),
        port_spec(spec), log=lambda _: None)
    load_torch_backbone_into(tm, path, log=tlog.append)
    got = tm.state_dict()
    assert set(want) == set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    # the file's tensors did land, fc and the counters stayed out
    key = PREFIX + "layer2.block1.reduce.conv.weight"
    np.testing.assert_array_equal(got[key].numpy(),
                                  sd["layer1.0.conv1.weight"].numpy())
    converted = torchvision_resnet_to_backbone(sd)
    assert not any("fc" in k or k.endswith("num_batches_tracked")
                   for k in converted)
    assert int(got[PREFIX + "layer1.conv1.bn.num_batches_tracked"]) == 0
    skipped = [ln for ln in tlog if ln.startswith("shape mismatch")]
    jskipped = [ln for ln in jlog if ln.startswith("shape mismatch")]
    assert len(skipped) == len(jskipped) == int(mismatch)
    if mismatch:
        bad = PREFIX + torchvision_key_to_deeplab(MISMATCHED)
        assert bad in skipped[0]
        np.testing.assert_array_equal(
            got[bad].numpy(),
            port_model(model, spec, variables).state_dict()[bad].numpy())


def test_backbone_from_a_port_checkpoint(flagship, tmp_path):
    model, spec, variables = flagship
    tm = port_model(model, spec, variables)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    src = synthetic_state_dict(tm, seed=11)
    stem = str(tmp_path / "ckpt" / "push_final")
    save_checkpoint(stem, src, port_spec(spec))
    logs = []
    load_backbone_checkpoint_into(tm, stem + ".ckpt", log=logs.append)
    for k, v in tm.state_dict().items():
        want = src[k] if k.startswith(PREFIX) else before[k].numpy()
        np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
    assert logs and "Loaded pretrained backbone" in logs[-1]


def test_refusals_by_name(flagship, tmp_path):
    from scaleprotoseg_tpu.checkpoints.io import save_checkpoint as jsave
    model, spec, variables = flagship
    tm = port_model(model, spec, variables)
    jpath = str(tmp_path / "jax" / "push_final.ckpt")
    os.makedirs(os.path.dirname(jpath))
    jsave(jpath, variables["params"], variables["batch_stats"], spec=spec)
    with pytest.raises(NotImplementedError, match="msgpack"):
        load_backbone_checkpoint_into(tm, jpath, log=lambda _: None)
    pickled = str(tmp_path / "module.pth")
    torch.save(torch.nn.Linear(2, 2), pickled)
    with pytest.raises(ValueError, match="unpickling"):
        load_torch_backbone_into(tm, pickled, log=lambda _: None)
    # a module handed over in memory gives its state_dict
    with pytest.raises(AssertionError, match="no convertible keys"):
        load_torch_backbone_into(tm, torch.nn.Linear(2, 2),
                                 log=lambda _: None)


TINY = ["train.warmup_steps = 0", "train.joint_steps = 0",
        "train.finetune_steps = 0", "train.push_proto = False",
        "construct_PPNet.base_architecture = 'deeplabv2_resnet50_multiscale'",
        "deeplabv2_resnet50_features_multiscale.deeplab_n_features = 16",
        "construct_PPNet.prototype_shape = (76, 16, 1, 1)",
        "PatchClassificationDataset.window_size = (33, 33)"]


@pytest.mark.parametrize("start", [False, True],
                         ids=["pretrained", "then_start_checkpoint"])
def test_trainer_reads_pretrained_backbone(tmp_path, monkeypatch, start):
    """The CLI with ``PRETRAINED_BACKBONE`` and ``pretrained = True``:
    ``push_final`` holds the file's backbone; a start checkpoint, read
    after it, wins."""
    bindings = configlib.parse_config_file(
        os.path.join(CONFIGS_DIR, "scaleproto_cityscapes.gin"))
    for line in TINY:
        for name, params in configlib.parse_config(line).items():
            bindings.setdefault(name, {}).update(params)
    shaped, spec = train_wandb_multiscale.build_model(bindings, seed=0)
    sd = torchvision_state_dict(shaped)
    path = str(tmp_path / "resnet50.pth")
    torch.save(sd, path)
    monkeypatch.setenv("PRETRAINED_BACKBONE", path)
    monkeypatch.delenv("PRETRAINED_BACKBONE_CKPT", raising=False)
    gin = TINY + ["construct_PPNet.pretrained = True"]
    if start:
        stem = str(tmp_path / "start" / "push_final")
        save_checkpoint(stem, synthetic_state_dict(shaped, seed=4), spec)
        gin.append(f"train.start_checkpoint = '{stem}.pth'")
    logs = []
    argv = ["scaleproto_cityscapes", "run", "--device", "cpu",
            "--data-root", build_synthetic_dataset(str(tmp_path / "data")),
            "--results-root", str(tmp_path / "results")]
    for line in gin:
        argv += ["--gin", line]
    monkeypatch.setattr(train_wandb_multiscale, "create_logger",
                        lambda *_: logs.append)
    out = train_wandb_multiscale.main(argv)
    final, _ = load_checkpoint(out["final"])
    want = to_tensors(synthetic_state_dict(shaped, seed=4)) if start else \
        torchvision_resnet_to_backbone(sd)
    for k, v in want.items():
        if k.startswith(PREFIX) and not k.endswith("num_batches_tracked"):
            assert torch.equal(final[k], v), k
    assert sum("loads nothing" in ln for ln in logs) == 1
    assert any(ln.startswith("Loaded pretrained backbone weights")
               for ln in logs)
