"""Checkpoint conversion of the port against the JAX package's, on the CPU.

- ``checkpoints.jax_ckpt`` (no ``msgpack``, no ``flax``) returns the
  trees ``flax.serialization.msgpack_restore`` returns, array for array
  (dtype, shape, bytes), on the JAX package's ``save_checkpoint`` output
  for the tiny flagship, a group model, a pushed and pruned irregular
  bank, EM's trainable-BN ``batch_stats`` and a ``quant_scales`` tree; on
  random nested payloads flax packs (hypothesis), on every msgpack width
  and on flax's chunked arrays; a truncated file, an unknown extension
  type and a byte that starts no object raise; in a process where
  ``msgpack``, ``flax`` and ``jax`` cannot be imported it reads the same.
- ``convert_checkpoint reference`` on reference-style whole-module
  pickles (the JAX package's ``test_reference_pickle_roundtrip`` modules:
  multiscale, group, leftover-bank group, pruned), then ``load_model``:
  the logits of the JAX package's ``convert_reference`` and its model,
  float32, rtol = atol = 1e-4; the spec alike; ``--config`` installs the
  config; a pickle that calls ``os.system`` or ``eval`` is refused and a
  marker file shows that nothing ran.
- ``export-torch``: the port's ``.pth`` equals the JAX package's
  ``export_torch`` output key for key and bit for bit, and ``load_model``
  on a run directory holding only the JAX ``.ckpt`` gives the JAX model's
  logits.
- ``torchvision``: the port's backbone file equals the JAX package's
  ``convert_checkpoint torchvision`` output carried across, and
  ``PRETRAINED_BACKBONE_CKPT`` reads either.
"""

import json
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import msgpack
from flax import serialization
from hypothesis import HealthCheck, given, settings as hsettings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from __graft_entry__ import synthetic_init
from scaleprotoseg_tpu import convert_checkpoint as jconvert
from scaleprotoseg_tpu.checkpoints.io import load_checkpoint as jload
from scaleprotoseg_tpu.checkpoints.io import save_checkpoint as jsave
from scaleprotoseg_tpu.checkpoints.io import spec_from_meta as jspec_meta
from scaleprotoseg_tpu.models.deeplab import DeepLabV2 as JDeepLabV2
from scaleprotoseg_tpu.models.ppnet import PPNet as JPPNet
from scaleprotoseg_torch import configlib
from scaleprotoseg_torch import convert_checkpoint as tconvert
from scaleprotoseg_torch.checkpoints import jax_ckpt
from scaleprotoseg_torch.checkpoints.convert import (load_jax_checkpoint,
                                                     ppnet_params_to_statedict)
from scaleprotoseg_torch.checkpoints.pretrained import (
    PREFIX, load_backbone_checkpoint_into)
from scaleprotoseg_torch.cli_common import CONFIGS_DIR
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.models import factory as tfactory
from test_reference_pickle_roundtrip import (_build_reference_style_module,
                                             _graft_group_head,
                                             _pop_fake_modules)
from test_torch_pretrained import torchvision_state_dict
from torch_parity import two_threads  # noqa: F401 (autouse)
from torch_parity import jax_flagship, port_model, port_spec, to_numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_FLAGSHIP = (1, 1, 2, 1)     # __graft_entry__._flagship(tiny=True)


def same(a, b, path="") -> None:
    """``a`` (the port's reader) is ``b`` (flax's): containers alike,
    arrays of one dtype, shape and bytes (bfloat16: a torch tensor against
    flax's ml_dtypes array, by bits), scalars of one type and value."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            same(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, list):
        assert isinstance(a, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(b, np.ndarray) and b.dtype.name == "bfloat16":
        assert isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
        assert tuple(a.shape) == b.shape, path
        assert a.view(torch.int16).numpy().tobytes() == b.tobytes(), path
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray), path
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        assert a.tobytes() == b.tobytes(), path
    else:
        assert type(a) is type(b), (path, type(a), type(b))
        if isinstance(b, np.generic):
            assert a.tobytes() == b.tobytes(), path
        else:
            assert a == b or (a != a and b != b), path


def _restored(path):
    with open(path, "rb") as f:
        blob = f.read()
    return jax_ckpt.msgpack_restore(blob), serialization.msgpack_restore(blob)


# ---------------------------------------------------------------------------
# the .ckpt reader
# ---------------------------------------------------------------------------
def _pruned(grouped=False):
    model, spec, variables = jax_flagship(grouped=grouped, seed=5)
    drop = [0, 7, 30, 31, 100, 227]
    keep = np.setdiff1d(np.arange(spec.num_prototypes), drop)
    params = to_numpy_tree(variables["params"])
    params["prototype_vectors"] = params["prototype_vectors"][keep]
    params["last_layer"] = params["last_layer"][keep]
    return params, to_numpy_tree(variables["batch_stats"]), spec.prune(drop)


def _em():
    from scaleprotoseg_tpu.models.unet import UNetASPP
    from scaleprotoseg_tpu.spec import ProtoSpec
    spec = ProtoSpec.equal_allocation(24, 8, num_classes=2, num_scales=4)
    model = JPPNet(backbone=UNetASPP(out_features=8, rates=(6, 12, 18, 24),
                                     multiscale=True, base=8),
                   spec=spec, backbone_channels=32)
    shapes = jax.eval_shape(lambda k: model.init(
        k, jnp.zeros((1, 32, 32, 3))), jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=6)
    assert variables["batch_stats"]
    return (to_numpy_tree(variables["params"]),
            to_numpy_tree(variables["batch_stats"]), spec)


def _quant_scales():
    rng = np.random.default_rng(8)
    tree = {}
    for layer, n in (("layer4", 2), ("layer5", 1)):
        for b in range(n):
            for unit in ("reduce", "conv3x3", "increase"):
                tree.setdefault("backbone", {}).setdefault(layer, {}) \
                    .setdefault(f"block{b + 1}", {})[unit] = {
                        "conv": {"x_scale": np.float32(rng.random() / 50)}}
    return tree, {}, None


def _flagship_trees(grouped):
    _, spec, variables = jax_flagship(grouped=grouped, seed=4)
    return (to_numpy_tree(variables["params"]),
            to_numpy_tree(variables["batch_stats"]), spec)


READER_CASES = {"flagship": lambda: _flagship_trees(False),
                "group": lambda: _flagship_trees(True),
                "pruned": _pruned, "em_batch_stats": _em,
                "quant_scales": _quant_scales}


@pytest.mark.parametrize("case", list(READER_CASES))
def test_reader_matches_flax(case, tmp_path):
    params, stats, spec = READER_CASES[case]()
    path = str(tmp_path / "stage.ckpt")
    jsave(path, params, stats, spec=spec, extra={"variant": case})
    ours, theirs = _restored(path)
    same(ours, theirs)
    got, want = jax_ckpt.load_checkpoint(path), jload(path)
    for a, b in zip(got, want):
        same(a, b)
    assert got[2]["extra"]["variant"] == case


leaves = (st.none() | st.booleans() | st.integers(-2 ** 63, 2 ** 64 - 1)
          | st.floats(allow_nan=False) | st.text(max_size=40)
          | st.binary(max_size=300)
          | st.complex_numbers(allow_nan=False, allow_infinity=False)
          | st.builds(np.float32, st.floats(width=32, allow_nan=False))
          | st.builds(np.int64, st.integers(-2 ** 63, 2 ** 63 - 1))
          | hnp.arrays(st.sampled_from(["float32", "float64", "int8",
                                         "uint16", "int32", "int64", "bool",
                                         "complex64", "float16"]),
                        hnp.array_shapes(min_dims=0, max_dims=3,
                                         max_side=5)))
payloads = st.recursive(
    leaves, lambda c: st.lists(c, max_size=4)
    | st.dictionaries(st.text(max_size=8), c, max_size=5), max_leaves=25)


@hsettings(max_examples=150, deadline=None,
           suppress_health_check=[HealthCheck.too_slow])
@given(tree=payloads)
def test_reader_matches_flax_on_random_payloads(tree):
    blob = serialization.msgpack_serialize({"params": tree})
    same(jax_ckpt.msgpack_restore(blob),
         serialization.msgpack_restore(blob))


def test_reader_every_width_and_chunks(monkeypatch):
    """Maps, arrays, str, bin and ext objects past 15 / 255 / 65535
    entries or bytes, float32 floats, negative fixints, and flax's chunked
    form of an array (its chunk size made small)."""
    n = 70000
    tree = {"map16": {str(i): i for i in range(300)},
            "map32": {str(i): -i for i in range(n)},
            "list": [-(2 ** 31), -1, -32, -33, 2 ** 40, 0.5] * 20000,
            "strs": ["x" * k for k in (5, 40, 300, n)],
            "bins": [b"\x01" * k for k in (1, 2, 4, 8, 16, 40, 300, n)],
            "arrays": [np.arange(k, dtype=np.uint8) for k in (1, 2, 4, 8,
                                                              16, 300, n)]}
    blob = serialization.msgpack_serialize(tree)
    same(jax_ckpt.msgpack_restore(blob), serialization.msgpack_restore(blob))
    single = msgpack.packb([1.5, -2.25, 3.0e38], use_single_float=True)
    assert jax_ckpt.msgpack_restore(single) == msgpack.unpackb(single)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = {"params": {"w": np.arange(1000, dtype=np.float32).reshape(
        10, 100), "b": np.ones(3, np.int64)}}
    blob = serialization.msgpack_serialize(big)
    assert b"__msgpack_chunked_array__" in blob
    same(jax_ckpt.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_reader_refusals(tmp_path):
    params, stats, spec = _flagship_trees(False)
    path = str(tmp_path / "push_final.ckpt")
    jsave(path, params, stats, spec=spec)
    with open(path, "rb") as f:
        blob = f.read()
    for cut in (len(blob) - 10, len(blob) // 2, 3):
        with pytest.raises(ValueError, match="truncated"):
            jax_ckpt.msgpack_restore(blob[:cut])
    with pytest.raises(ValueError, match="extension type 9"):
        jax_ckpt.msgpack_restore(msgpack.packb(
            {"params": msgpack.ExtType(9, b"abc")}))
    with pytest.raises(ValueError, match="extension type -1"):
        # msgpack's timestamp (a fixext 4 of type -1), which flax never
        # writes
        jax_ckpt.msgpack_restore(b"\x81\xa6params\xd6\xff" + b"\x00" * 4)
    with pytest.raises(ValueError, match="0xc1"):
        jax_ckpt.msgpack_restore(b"\x81\xa1a\xc1")
    with pytest.raises(ValueError, match="after the object"):
        jax_ckpt.msgpack_restore(blob + b"\x00")


def test_reader_without_msgpack_flax_or_jax(tmp_path):
    """The reader in a fresh interpreter where ``msgpack``, ``flax`` and
    ``jax`` cannot be imported (the GPU machine has none of them)."""
    params, stats, spec = _flagship_trees(True)
    path = str(tmp_path / "final-group.ckpt")
    jsave(path, params, stats, spec=spec)
    code = (
        "import sys\n"
        "for m in ('msgpack', 'flax', 'jax', 'jaxlib', 'ml_dtypes'):\n"
        "    sys.modules[m] = None\n"
        "from scaleprotoseg_torch.checkpoints.convert import "
        "load_jax_checkpoint\n"
        f"sd, meta = load_jax_checkpoint({path!r})\n"
        "import torch\n"
        f"torch.save(sd, {str(tmp_path / 'carried.pth')!r})\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO))
    got = torch.load(str(tmp_path / "carried.pth"), weights_only=True)
    want = ppnet_params_to_statedict(params, stats, port_spec(spec),
                                     log=lambda _: None)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


# ---------------------------------------------------------------------------
# reference whole-module pickles
# ---------------------------------------------------------------------------
def _reference_module(case):
    if case == "multiscale":
        return _build_reference_style_module()[0]
    if case == "group":
        model, spec = _build_reference_style_module(seed=1)
        return _graft_group_head(model, spec)
    if case == "leftover_group":
        model, spec = _build_reference_style_module(
            num_prototypes=10, num_classes=2, seed=2)
        return _graft_group_head(model, spec, num_groups=2)
    model, spec = _build_reference_style_module(seed=3)     # pruned
    keep = [i for i in range(24) if i not in (0, 5, 7, 13, 18, 23)]
    with torch.no_grad():
        model.prototype_vectors = torch.nn.Parameter(
            model.prototype_vectors.data[keep])
        model.last_layer.weight.data = model.last_layer.weight.data[:, keep]
        model.ones = torch.nn.Parameter(model.ones.data[keep],
                                        requires_grad=False)
        model.prototype_class_identity = \
            model.prototype_class_identity[keep, :]
    ranges, pos = {}, 0
    for s, (lo, hi) in enumerate(spec.scale_bounds):
        n = sum(1 for i in keep if lo <= i < hi)
        ranges[s] = (pos, pos + n)
        pos += n
    model.scale_num_prototypes = ranges
    return model


TINY_CONFIG = """\
construct_PPNet.base_architecture = 'deeplabv2_resnet101_multiscale'
construct_PPNet.prototype_shape = (24, 8, 1, 1)
construct_PPNet.add_on_layers_type = 'deeplab_simple'
deeplabv2_resnet101_features_multiscale.deeplab_n_features = 8
PPNetMultiScale.num_scales = 4
"""


@pytest.fixture
def tiny_tables(monkeypatch):
    for name, (cfg, _, mode) in list(tfactory._BACKBONES.items()):
        monkeypatch.setitem(tfactory._BACKBONES, name, (cfg, (1, 1, 1, 1),
                                                        mode))


@pytest.mark.parametrize("case", ["multiscale", "group", "leftover_group",
                                  "pruned"])
def test_reference_pickle_matches_jax(case, tmp_path, tiny_tables):
    model = _reference_module(case)
    src = str(tmp_path / "final.pth")
    torch.save(model, src)
    _pop_fake_modules()
    run = tmp_path / "run"
    os.makedirs(run)
    (run / "config.gin").write_text(TINY_CONFIG)
    logs = []
    stem = tconvert.convert_reference(
        src, str(run / "checkpoints" / "final.pth"), log=logs.append)
    assert any("'ones'" in m for m in logs)     # named, not carried
    jdst = str(tmp_path / "jax" / "final.ckpt")
    jconvert.convert_reference(src, jdst)
    params, stats, meta = jload(jdst)
    jspec = jspec_meta(meta["spec"])
    with open(stem + ".ckpt.json") as f:
        tmeta = json.load(f)
    assert tmeta["spec"] == json.loads(json.dumps(meta["spec"]))
    assert tmeta["extra"]["variant"] == meta["extra"]["variant"]
    grouped = meta["extra"]["variant"] == "group"
    jmodel = JPPNet(backbone=JDeepLabV2(n_out=8, n_blocks=(1, 1, 1, 1),
                                        aspp_mode="concat"),
                    spec=jspec, backbone_channels=32, grouped=grouped)
    x = np.random.default_rng(3).standard_normal(
        (2, 41, 57, 3)).astype(np.float32)
    variables = {"params": jax.tree.map(jnp.asarray, params),
                 "batch_stats": jax.tree.map(jnp.asarray, stats)}
    want = jmodel.apply(variables, jnp.asarray(x))
    tm, tspec = load_model(str(run), stem + ".pth", device="cpu")
    assert tspec == port_spec(jspec)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for f in ("logits", "distances"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-4,
                                   atol=1e-4, err_msg=f)
    if case == "pruned":     # the pushed bank's irregular scale ranges
        assert len({hi - lo for lo, hi in tspec.scale_bounds}) > 1


def test_reference_config_installs_config_gin(tmp_path):
    model = _reference_module("group")
    src = str(tmp_path / "final-group.pth")
    torch.save(model, src)
    _pop_fake_modules()
    name = "group_scaleproto_cityscapes"
    dst = tmp_path / "results" / "zenodo" / "checkpoints" / "final-group.pth"
    stem = tconvert.main(["reference", src, str(dst), "--config", name])
    assert stem == str(dst)[:-len(".pth")]
    installed = tmp_path / "results" / "zenodo" / "config.gin"
    with open(os.path.join(CONFIGS_DIR, name + ".gin")) as f:
        assert installed.read_text() == f.read()
    jdst = tmp_path / "jax_results" / "zenodo" / "checkpoints" / "fg.ckpt"
    jconvert.convert_reference(src, str(jdst), config=name)
    assert configlib.parse_config_file(str(installed)) == \
        configlib.parse_config_file(str(jdst.parent.parent / "config.gin"))


class _CallOnLoad:
    """Unpickles as a call of ``fn(*args)``."""

    def __init__(self, fn, args):
        self.fn, self.args = fn, args

    def __reduce__(self):
        return self.fn, self.args


@pytest.mark.parametrize("callable_", ["os.system", "builtins.eval"])
def test_reference_pickle_that_calls_is_refused(callable_, tmp_path):
    marker = tmp_path / "ran"
    if callable_ == "os.system":
        payload = _CallOnLoad(os.system, (f"touch {marker}",))
        name = "system"
    else:
        payload = _CallOnLoad(eval, (f"open({str(marker)!r}, 'w')",))
        name = "builtins.eval"
    model = _reference_module("multiscale")
    model.payload = payload
    src = str(tmp_path / "push_final.pth")
    torch.save(model, src)
    _pop_fake_modules()
    dst = tmp_path / "run" / "checkpoints" / "push_final.pth"
    with pytest.raises(pickle.UnpicklingError, match=f"{name}.*refused"):
        tconvert.main(["reference", src, str(dst)])
    assert not marker.exists() and not dst.exists()


# ---------------------------------------------------------------------------
# export-torch and a run directory of the JAX package's .ckpt
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
def test_export_torch_bit_equal_and_jax_run_dir_served(grouped, tmp_path,
                                                       monkeypatch):
    for name, (cfg, _, mode) in list(tfactory._BACKBONES.items()):
        monkeypatch.setitem(tfactory._BACKBONES, name,
                            (cfg, TINY_FLAGSHIP, mode))
    model, spec, variables = jax_flagship(grouped=grouped, side=41, seed=9)
    stage = "final-group" if grouped else "push_final"
    run = tmp_path / "jax_run"
    src = str(run / "checkpoints" / f"{stage}.ckpt")
    os.makedirs(os.path.dirname(src))
    jsave(src, variables["params"], variables["batch_stats"], spec=spec,
          extra={"variant": "group" if grouped else "multiscale"})
    config = "group_scaleproto_cityscapes" if grouped else \
        "scaleproto_cityscapes"
    with open(os.path.join(CONFIGS_DIR, config + ".gin")) as f:
        (run / "config.gin").write_text(f.read())

    jconvert.export_torch(src, str(tmp_path / "jax_export.pth"))
    theirs = torch.load(str(tmp_path / "jax_export.pth"), weights_only=True)
    stem = tconvert.main(["export-torch", src,
                          str(tmp_path / "port" / f"{stage}.pth")])
    ours = torch.load(stem + ".pth", weights_only=True)
    assert list(ours) == list(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k
    with open(stem + ".ckpt.json") as f, open(src + ".json") as g:
        assert json.load(f) == json.load(g)

    x = np.random.default_rng(10).standard_normal(
        (2, 41, 57, 3)).astype(np.float32)
    want = np.asarray(model.apply(variables, jnp.asarray(x)).logits)
    assert not os.path.exists(src[:-len(".ckpt")] + ".pth")
    tm, tspec = load_model(str(run), src, device="cpu")
    assert tspec == port_spec(spec)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    # the reference-named tensors carried in memory are the export's
    for k, v in tm.state_dict().items():
        assert torch.equal(v, ours[k]), k


# ---------------------------------------------------------------------------
# torchvision
# ---------------------------------------------------------------------------
def test_torchvision_matches_jax_carried_across(tmp_path):
    model, spec, variables = jax_flagship(grouped=False, seed=3)
    tm = port_model(model, spec, variables)
    src = str(tmp_path / "resnet.pth")
    torch.save(torchvision_state_dict(tm, seed=12), src)
    jdst = str(tmp_path / "jax" / "backbone.ckpt")
    jconvert.convert_torchvision(src, jdst)
    carried, meta = load_jax_checkpoint(jdst, log=lambda _: None)
    assert "spec" not in meta
    stem = tconvert.main(["torchvision", src, str(tmp_path / "port" /
                                                  "backbone.pth")])
    ours = torch.load(stem + ".pth", weights_only=True)
    assert set(ours) == set(carried) and all(k.startswith(PREFIX)
                                             for k in ours)
    for k, v in carried.items():
        assert ours[k].dtype == v.dtype and torch.equal(ours[k], v), k
    # PRETRAINED_BACKBONE_CKPT reads the port's file and the JAX .ckpt alike
    for path in (stem, jdst):
        fresh = port_model(model, spec, variables)
        load_backbone_checkpoint_into(fresh, path, log=lambda _: None)
        state = fresh.state_dict()
        for k, v in ours.items():
            assert torch.equal(state[k], v), (path, k)


def test_committed_jax_ckpt_fixture(tmp_path):
    """``tests/torch_fixtures/jax_ckpt`` (``tools/make_jax_ckpt_fixture.py``)
    as its manifest lists it; the run served from its ``.ckpt`` gives the
    logits of its ``export-torch`` twin, as ``chip_smoke.py`` holds them
    on the card."""
    import hashlib
    import shutil
    fixture = os.path.join(REPO, "tests", "torch_fixtures", "jax_ckpt")
    with open(os.path.join(fixture, "MANIFEST.json")) as f:
        manifest = json.load(f)
    for name, entry in manifest.items():
        with open(os.path.join(fixture, name), "rb") as f:
            data = f.read()
        assert len(data) == entry["bytes"], name
        assert hashlib.sha256(data).hexdigest() == entry["sha256"], name
    assert sum(e["bytes"] for e in manifest.values()) < 2 ** 20
    same(*_restored(os.path.join(fixture, "final-group.ckpt")))
    runs = {}
    for kind, files in (("jax", ["final-group.ckpt",
                                 "final-group.ckpt.json"]),
                        ("twin", ["final-group_twin.pth",
                                  "final-group.ckpt.json"])):
        run = tmp_path / kind
        os.makedirs(run / "checkpoints")
        shutil.copyfile(os.path.join(fixture, "config.gin"),
                        run / "config.gin")
        for name in files:
            shutil.copyfile(os.path.join(fixture, name),
                            run / "checkpoints" / name.replace("_twin", ""))
        runs[kind] = str(run)
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    out = {}
    for kind, run in runs.items():
        model, spec = load_model(run, os.path.join(
            run, "checkpoints", "final-group.ckpt"), device="cpu")
        with torch.no_grad():
            out[kind] = model.fast_logits(x)
    assert spec.num_groups == 3 and out["jax"].shape == (2, 64, 64, 2)
    assert torch.equal(out["jax"], out["twin"])
