"""Purity pruning, its last-layer re-finetune, group thresholding and the
test-split export of the port against the JAX package, on the CPU.

The tiny-depth flagship (full widths: 228 prototypes of depth 64, plain
and grouped) with the JAX package's synthetic weights, carried over by
``ppnet_params_to_statedict``, on seeded 33 x 33 batches whose labels
hold void and every class in blocks (or only void and classes 0-9, so
that purity pruning empties the classes 10-18):

- ``find_k_nearest_patches_to_prototypes``: the (P, k) labels, images and
  flat pixels equal to the JAX package's, and the distances within 1e-5
  relative, wherever the JAX package's own distances decide them (each
  rank's distance apart from its neighbours' and each winning pixel apart
  from the image's second best by more than 1e-4 (1 + d): torch and XLA
  float32 differ by ~1e-6), also with a split smaller than k and an image
  that is all void;
- ``prune_prototypes``: the kept indices, ``prune_info.npy``,
  ``prototypes_to_keep.json`` and the pruned state dict equal, both heads,
  a class emptied or not; the pruned models' logits within 1e-4;
- one phase-2 step of the pruned model against the JAX package's
  ``make_train_step`` at the tolerances of ``test_train_step_matches_jax
  [last]``;
- ``threshold_save``: group weights bit-equal to the JAX package's on the
  same checkpoint, rows not re-normalised, a plain checkpoint refused;
- ``eval_test``: PNG values equal to the JAX package's ``--fp32`` export
  wherever the top-two margin of its upsampled logits is at least 1e-5,
  and ``train_id_to_source_lut`` equal;
- the CLIs end to end with ``--device cpu``: the prototype phase, then
  ``run_pruning``, ``train_wandb --pruned`` (only the last layer moves),
  ``eval_test``, the validation-set evaluation and serving of the
  ``pruned`` phase; and the refusals.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship, synthetic_init
from scaleprotoseg_tpu import eval_test as jeval_test
from scaleprotoseg_tpu import find_nearest as jfind
from scaleprotoseg_tpu import prune as jprune
from scaleprotoseg_tpu.ops.resize import (resize_bilinear as jresize,
                                          resize_label_nearest)
from scaleprotoseg_torch import eval_test as teval_test
from scaleprotoseg_torch import eval_valid_multiscale
from scaleprotoseg_torch import find_nearest as tfind
from scaleprotoseg_torch import prune as tprune
from scaleprotoseg_torch import run_pruning, train_wandb
from scaleprotoseg_torch import train_wandb_multiscale as trainer
from scaleprotoseg_torch.analysis import threshold_save as tthreshold
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     ppnet_params_to_statedict,
                                                     save_checkpoint)
from scaleprotoseg_torch.imageio import read_png
from scaleprotoseg_torch.models.ppnet import PPNet
from scaleprotoseg_torch.serving import serve
from scaleprotoseg_torch.train import optim as toptim
from e2e_utils import build_synthetic_dataset
from test_torch_train_step import (_batch, _jax_steps, _names, _offsets,
                                   _port_step_fn, HP)
from torch_parity import (labels_equal_outside_ties, port_model, port_spec,
                          to_numpy_tree)
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

SIDE = 33


class Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def _batches(seed=0, n=3, classes=19, all_void=False):
    """Seeded batches of two 33 x 33 images; labels in 4 x 5 blocks of
    void and classes 0..``classes - 1`` (stored + 1), rolled per image;
    ``all_void`` appends a batch of one image that is void throughout."""
    rng = np.random.default_rng(seed)
    y = np.repeat(np.repeat(np.arange(20).reshape(4, 5) % (classes + 1), 9,
                            0), 7, 1)
    out = []
    for i in range(n):
        x = rng.standard_normal((2, SIDE, SIDE, 3)).astype(np.float32)
        labels = np.stack([np.roll(y[:SIDE, :SIDE], (3 * i + s, 5 * s),
                                   axis=(0, 1)) for s in (0, 1)])
        out.append((x, labels.astype(np.int32)))
    if all_void:
        out.append((rng.standard_normal((1, SIDE, SIDE, 3))
                    .astype(np.float32), np.zeros((1, SIDE, SIDE), np.int32)))
    return out


def _jax_model(grouped, seed=0):
    model, spec = _flagship(tiny=True, grouped=grouped, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    return model, spec, synthetic_init(shapes, seed=seed)


def _jax_nearest(monkeypatch, model, variables, spec, loader, k):
    """The JAX package's labels and its merged top-k (distances, images,
    pixels), the latter caught at its artifact writer."""
    caught = {}

    def catch(loader_, model_, variables_, spec_, top_d, top_img, top_flat,
              grid_shape, root, log):
        caught.update(top_d=top_d, top_img=top_img, top_flat=top_flat)

    monkeypatch.setattr(jfind, "_save_artifacts", catch)
    labels = jfind.find_k_nearest_patches_to_prototypes(
        loader, model, variables, spec, k=k, full_save=True,
        root_dir_for_saving_images="unused", log=lambda _: None)
    return labels, caught


def _decided(model, variables, spec, loader, top_img):
    """(rank decided (P, k), pixel decided (P, k), all-void (P, k)) from
    the JAX package's own void-masked distances."""
    per_image = []
    for x, y in loader:
        _, d = model.apply(variables, jnp.asarray(x), method="push_forward")
        t = resize_label_nearest(jnp.asarray(y), d.shape[1], d.shape[2]) - 1
        masked = d + jfind.VOID_PENALTY * (t < 0)[..., None]
        per_image.append(np.asarray(masked).reshape(len(x), -1, d.shape[-1]))
    m = np.concatenate(per_image)                        # (N, hw, Pa)
    two = np.sort(m, axis=1)[:, :2]                      # (N, 2, Pa)
    pix_ok = (two[:, 1] - two[:, 0]) > 1e-4 * (1 + two[:, 0])   # (N, Pa)
    void = np.concatenate([(np.asarray(y) == 0).reshape(len(y), -1).all(1)
                           for _, y in loader])
    n, pa = m.shape[0], m.shape[2]
    P, k = top_img.shape
    ranks = np.full((P, k + 1), np.inf)
    ranks[:pa, :min(n, k + 1)] = np.sort(two[:, 0], axis=0)[:k + 1].T
    with np.errstate(invalid="ignore"):      # inf - inf past the split
        gap = np.diff(ranks, axis=1)
    tol = 1e-4 * (1 + ranks[:, :-1])
    prev_ok = np.concatenate([np.ones((P, 1), bool), gap[:, :-1] >
                              tol[:, :-1]], 1)
    rank_ok = (gap > tol) & prev_ok
    img = np.clip(top_img, 0, n - 1)
    cols = np.minimum(np.arange(P), pa - 1)[:, None]
    return rank_ok, pix_ok[img, cols] & (top_img >= 0), void[img]


@pytest.mark.parametrize("case", ["k6", "split_smaller_than_k"])
@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
def test_find_nearest_matches_jax(monkeypatch, grouped, case):
    model, spec, variables = _jax_model(grouped)
    k = 6 if case == "k6" else 8
    loader = Loader(_batches(n=3, all_void=case != "k6"))
    want, caught = _jax_nearest(monkeypatch, model, variables, spec, loader,
                                k)
    tm = port_model(model, spec, variables)
    tspec = port_spec(spec)
    got = tfind.find_k_nearest_patches_to_prototypes(loader, tm, tspec, k=k,
                                                     log=lambda _: None)
    top_d, top_img, top_flat, grid = tfind.nearest_patches(
        loader, tm, tspec, k, log=lambda _: None)
    assert got.shape == want.shape == (spec.num_prototypes, k)
    rank_ok, pix_ok, void = _decided(model, variables, spec, loader,
                                     caught["top_img"])
    assert rank_ok.mean() > 0.8 and pix_ok[rank_ok].mean() > 0.8
    np.testing.assert_array_equal(top_img[rank_ok],
                                  caught["top_img"][rank_ok])
    flat_ok = rank_ok & pix_ok & ~void
    np.testing.assert_array_equal(top_flat[flat_ok],
                                  caught["top_flat"][flat_ok])
    label_ok = rank_ok & (pix_ok | void)
    np.testing.assert_array_equal(got[label_ok], want[label_ok])
    finite = np.isfinite(caught["top_d"])
    np.testing.assert_array_equal(np.isfinite(top_d), finite)
    np.testing.assert_allclose(top_d[finite], caught["top_d"][finite],
                               rtol=1e-5)
    if case != "k6":
        # 7 images for k = 8: the last rank is empty, and the all-void
        # image (found only through its penalty) gives void labels
        assert (top_img[:, 7] == -1).all() and (got[:, 7] == -1).all()
        on_void = top_img[:spec.num_active_prototypes] == 6
        assert on_void.any() and (got[:spec.num_active_prototypes]
                                  [on_void] == -1).all()


def test_find_nearest_full_save_matches_jax(tmp_path):
    """``full_save`` of both packages (k = 1, the nearest patch): for every
    prototype whose nearest patch both scans decide alike, the activation
    within 1e-6, ``_original.png`` and ``_patch.png`` equal in decoded
    pixels; ``_bbox.png`` (the port's rendering) is the original with the
    patch's outline in yellow."""
    Image = pytest.importorskip("PIL.Image")
    pytest.importorskip("matplotlib")
    model, spec, variables = _jax_model(False, seed=3)
    loader = Loader(_batches(seed=4, n=2))
    jfind.find_k_nearest_patches_to_prototypes(
        loader, model, variables, spec, k=1, full_save=True,
        root_dir_for_saving_images=str(tmp_path / "jax"), log=lambda _: None)
    tm = port_model(model, spec, variables)
    tspec = port_spec(spec)
    tfind.find_k_nearest_patches_to_prototypes(
        loader, tm, tspec, k=1, full_save=True,
        root_dir_for_saving_images=str(tmp_path / "port"), log=lambda _: None)
    _, top_img, top_flat, _ = tfind.nearest_patches(loader, tm, tspec, 1,
                                                    log=lambda _: None)
    rank_ok, pix_ok, _ = _decided(model, variables, spec, loader, top_img)
    decided = (rank_ok & pix_ok)[:, 0]
    assert decided.mean() > 0.8
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    for p in np.nonzero(decided)[0]:
        a, b = tmp_path / "jax" / str(p), tmp_path / "port" / str(p)
        np.testing.assert_allclose(np.load(b / "nearest-1_act.npy"),
                                   np.load(a / "nearest-1_act.npy"),
                                   rtol=0, atol=1e-6)
        for name in ("nearest-1_original.png", "nearest-1_patch.png"):
            np.testing.assert_array_equal(np.asarray(Image.open(b / name)),
                                          np.asarray(Image.open(a / name)))
        original = read_png(str(b / "nearest-1_original.png"))
        box = read_png(str(b / "nearest-1_bbox.png"))
        changed = (box != original).any(-1)
        assert changed.any()
        assert (box[changed][:, :3] == [255, 255, 0]).all()
        gi, gj = divmod(int(top_flat[p, 0]), 5)
        h0, w0 = int(gi * SIDE / 5), int(gj * SIDE / 5)
        assert box[h0, w0, :3].tolist() == [255, 255, 0]


@pytest.mark.parametrize("classes", [19, 10], ids=["all_classes",
                                                   "class_emptied"])
@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
def test_prune_prototypes_matches_jax(tmp_path, grouped, classes):
    model, spec, variables = _jax_model(grouped, seed=1)
    loader = Loader(_batches(seed=2, n=4, classes=classes))
    jparams, jspec, jkeep = jprune.prune_prototypes(
        loader, model, variables, spec, k=6, prune_threshold=3,
        original_model_dir=str(tmp_path / "jax"), log=lambda _: None)
    tm = port_model(model, spec, variables)
    state, tspec, tkeep = tprune.prune_prototypes(
        loader, tm, port_spec(spec), k=6, prune_threshold=3,
        original_model_dir=str(tmp_path / "port"), log=lambda _: None)
    np.testing.assert_array_equal(tkeep, jkeep)
    assert tspec == port_spec(jspec)
    assert 0 < len(tkeep) < spec.num_prototypes
    emptied = {c for c in range(19) if tspec.class_counts[c] == 0}
    if classes == 10:       # the classes absent from the labels
        assert set(range(10, 19)) <= emptied, emptied
    book = "pruned_prototypes_epoch0_k6_pt3"
    np.testing.assert_array_equal(
        np.load(tmp_path / "port" / book / "prune_info.npy"),
        np.load(tmp_path / "jax" / book / "prune_info.npy"))
    assert json.loads((tmp_path / "port" / book /
                       "prototypes_to_keep.json").read_text()) == \
        json.loads((tmp_path / "jax" / book /
                    "prototypes_to_keep.json").read_text())
    want = ppnet_params_to_statedict(
        to_numpy_tree(jparams), to_numpy_tree(variables["batch_stats"]),
        tspec, log=lambda _: None)
    assert sorted(state) == sorted(want)
    for key, v in want.items():
        np.testing.assert_array_equal(state[key].numpy(), v, err_msg=key)
    # the pruned models agree: an emptied class's logits come from the
    # last layer's remaining columns alone
    pruned_j = dataclasses.replace(model, spec=jspec)
    pvars = {"params": jparams, "batch_stats": variables["batch_stats"]}
    x = np.random.default_rng(3).standard_normal(
        (1, SIDE, SIDE, 3)).astype(np.float32)
    ref = np.asarray(pruned_j.apply(pvars, jnp.asarray(x),
                                    train=False).logits)
    pruned_t = PPNet(tm.features.base, tspec, grouped=grouped)
    pruned_t.load_state_dict(state, strict=True)
    with torch.no_grad():
        out = pruned_t.eval()(torch.from_numpy(x)).logits.numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_pruned_last_layer_step_matches_jax(tmp_path):
    """Two phase-2 micro-steps (``iter_size`` 2) of a purity-pruned plain
    model, a class emptied, against the JAX package's: metrics within
    1e-4, the accumulated last-layer gradient within 1e-4 of its largest
    entry, the update within 1e-4 where Adam's step direction is decided,
    every other parameter unchanged."""
    model, spec, variables = _jax_model(False, seed=1)
    loader = Loader(_batches(seed=2, n=4, classes=10))
    jparams, jspec, _ = jprune.prune_prototypes(
        loader, model, variables, spec, k=6, prune_threshold=3,
        log=lambda _: None)
    pmodel = dataclasses.replace(model, spec=jspec)
    pvars = {"params": jparams, "batch_stats": variables["batch_stats"]}
    tm = port_model(pmodel, jspec, pvars)
    tspec = port_spec(jspec)
    x, y = _batch()
    (s1, m1), (s2, m2) = _jax_steps(pmodel, jspec, pvars, 2, x, y)[0]
    state, step = _port_step_fn(tm, 2)
    got = []
    for _ in range(2):
        got.append({k: float(v) for k, v in step(
            state, torch.from_numpy(x), torch.from_numpy(y)).items()})
        if len(got) == 1:
            acc = {name: state.optimizer._acc[off:off + p.numel()]
                   .view_as(p).clone().numpy()
                   for name, p, off in _offsets(tm, state.optimizer)}
    for want, have in ((m1, got[0]), (m2, got[1])):
        for k, v in want.items():
            assert have[k] == pytest.approx(v, rel=1e-4, abs=1e-4), k
    grads = _names(s1.opt_state.inner_state.acc_grads, tspec)
    assert set(grads) == set(acc) == {"last_layer.weight"}
    g = grads["last_layer.weight"]
    np.testing.assert_allclose(acc["last_layer.weight"], g, rtol=0,
                               atol=1e-4 * np.abs(g).max())
    init = _names(pvars["params"], tspec)
    new = _names(s2.params, tspec)
    have = tm.state_dict()
    for name, w in new.items():
        if name != "last_layer.weight":
            np.testing.assert_array_equal(have[name].numpy(), init[name],
                                          err_msg=name)
    wd = toptim.phase_groups("multiscale", 2, HP)[
        toptim.label_of_path("last_layer.weight")].weight_decay
    u = g + wd * init["last_layer.weight"]
    decided = np.abs(acc["last_layer.weight"] + wd *
                     init["last_layer.weight"] - u) < 0.1 * np.abs(u)
    assert decided.mean() >= 0.999
    np.testing.assert_allclose(have["last_layer.weight"].numpy()[decided],
                               new["last_layer.weight"][decided], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("grouped", [True, False], ids=["group", "plain"])
def test_threshold_save_matches_jax(tmp_path, monkeypatch, grouped):
    from scaleprotoseg_tpu.analysis.threshold_save import threshold_save
    from scaleprotoseg_tpu.checkpoints.io import load_checkpoint as jload
    from scaleprotoseg_tpu.checkpoints.io import save_checkpoint as jsave
    model, spec, variables = _jax_model(grouped, seed=4)
    tspec = port_spec(spec)
    params = to_numpy_tree(variables["params"])
    sd = ppnet_params_to_statedict(params, to_numpy_tree(
        variables["batch_stats"]), tspec, log=lambda _: None)
    extra = {"variant": "group" if grouped else "multiscale"}
    run = tmp_path / "run" / "checkpoints"
    save_checkpoint(str(run / "final-group"), sd, tspec, extra=extra)
    if not grouped:
        with pytest.raises(ValueError, match="group_projection"):
            tthreshold.main(["run", "final-group", "0.1", "--results-root",
                             str(tmp_path), "--device", "cpu"])
        return
    monkeypatch.setenv("RESULTS_DIR", str(tmp_path / "jax"))
    jsave(str(tmp_path / "jax" / "run" / "checkpoints" / "final-group.ckpt"),
          variables["params"], variables["batch_stats"], spec=spec,
          extra=extra)
    jout = threshold_save("run", "final-group", 0.1)
    tout = tthreshold.main(["run", "final-group", "0.1", "--results-root",
                            str(tmp_path), "--device", "cpu"])
    assert os.path.basename(tout) + ".ckpt" == os.path.basename(jout) == \
        "th-0.1-final-group_last.ckpt"
    jparams, _, _ = jload(jout)
    want = ppnet_params_to_statedict(to_numpy_tree(jparams), None, tspec,
                                     log=lambda _: None)
    got, meta = load_checkpoint(tout)
    assert meta["extra"] == extra
    assert meta["spec"] == tspec.to_meta()
    zeroed = 0
    for key, v in sd.items():
        if key.startswith("group_projection."):
            np.testing.assert_array_equal(got[key].numpy(), want[key])
            w = got[key].numpy()
            assert ((w == 0) | (w >= 0.1)).all()
            np.testing.assert_array_equal(w[w >= 0.1], v[v >= 0.1])
            zeroed += int(((v > 0) & (v < 0.1)).sum())
        else:
            np.testing.assert_array_equal(got[key].numpy(), v, err_msg=key)
    # entries were zeroed and the rows are left below 1
    assert zeroed > 0
    sums = np.concatenate([got[k].numpy().sum(-1) for k in got
                           if k.startswith("group_projection.")])
    assert (sums < 1 - 1e-6).any()


def test_eval_test_matches_jax_fp32_export(tmp_path, monkeypatch):
    """Both packages' ``eval_test`` on the same model (the JAX side with
    ``--fp32``) over three test images, two of one shape and one of
    another: the PNG values agree outside ties."""
    Image = pytest.importorskip("PIL.Image")
    model, spec, variables = _jax_model(False, seed=5)
    tm = port_model(model, spec, variables)
    tspec = port_spec(spec)
    root = tmp_path / "data"
    test_dir = root / "img_with_margin_0" / "test"
    test_dir.mkdir(parents=True)
    rng = np.random.default_rng(6)
    shapes = {"a": (33, 41), "b": (33, 41), "c": (29, 37)}
    for name, (h, w) in shapes.items():
        np.save(test_dir / f"{name}.npy",
                rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    monkeypatch.setattr(jeval_test, "load_model",
                        lambda *a, **k: (model, spec, variables))
    monkeypatch.setattr(teval_test, "load_model",
                        lambda *a, **k: (tm, tspec))
    jdir = jeval_test.run_evaluation(
        "run", "pruned", batch_size=2, data_root=str(root),
        results_root=str(tmp_path / "jax"), fp32=True)
    tdir = teval_test.main(["run", "pruned", "2", "--data-root", str(root),
                            "--results-root", str(tmp_path / "port"),
                            "--device", "cpu"])
    assert tdir.endswith(os.path.join("run", "evaluation", "test", "pruned"))
    lut = teval_test.train_id_to_source_lut()
    np.testing.assert_array_equal(lut, jeval_test.train_id_to_source_lut(
        False))
    inv = {int(v): i for i, v in enumerate(lut[1:20])}
    mean = np.asarray((0.485, 0.456, 0.406), np.float32)
    std = np.asarray((0.229, 0.224, 0.225), np.float32)
    for name, (h, w) in shapes.items():
        got = read_png(os.path.join(tdir, f"{name}.png"))
        want = np.asarray(Image.open(os.path.join(jdir, f"{name}.png")))
        assert got.shape == want.shape == (h, w) and got.dtype == np.uint8
        assert set(np.unique(got)) <= set(lut[1:20].tolist())
        x = (np.load(test_dir / f"{name}.npy").astype(np.float32) / 255.0
             - mean) / std
        logits = model.apply(variables, jnp.asarray(x[None]),
                             train=False).logits
        up = np.asarray(jresize(logits, h, w))[0]
        to_id = np.vectorize(inv.get)
        labels_equal_outside_ties(to_id(got), to_id(want), up)
    # --pascal's label map (its export: tests/test_torch_pascal.py)
    np.testing.assert_array_equal(teval_test.train_id_to_source_lut(True),
                                  jeval_test.train_id_to_source_lut(True))


TINY = ["train.warmup_steps = 2", "train.joint_steps = 2",
        "train.finetune_steps = 2",
        "construct_PPNet.base_architecture = 'deeplabv2_resnet50_multiscale'",
        "deeplabv2_resnet50_features_multiscale.deeplab_n_features = 16",
        "construct_PPNet.prototype_shape = (76, 16, 1, 1)",
        "PatchClassificationDataset.window_size = (33, 33)",
        "PatchClassificationModuleMultiScale.iter_size = 1",
        "PatchClassificationDataModule.dataloader_n_jobs = 2"]


def test_pruning_clis_on_cpu(tmp_path):
    """The prototype-phase CLI (push with its artifacts), ``run_pruning``
    (k = 6, threshold 3, as the README runs it), ``train_wandb --pruned``
    and ``eval_test`` of the ``pruned`` phase, all with ``--device cpu``
    on a narrow ResNet-50 and 48 x 48 images."""
    root = build_synthetic_dataset(str(tmp_path / "data"), n_train=4,
                                   n_val=2, size=48)
    test_dir = os.path.join(root, "img_with_margin_0", "test")
    os.makedirs(test_dir)
    rng = np.random.default_rng(0)
    for i in range(3):
        np.save(os.path.join(test_dir, f"t{i}.npy"),
                rng.integers(0, 256, (40, 44, 3), dtype=np.uint8))
    results = str(tmp_path / "res")
    common = ["--device", "cpu", "--data-root", root, "--results-root",
              results]
    gin = [a for line in TINY for a in ("--gin", line)]
    out = trainer.main(["scaleproto_cityscapes", "run"] + common + gin)
    run = os.path.join(results, "run")
    bb = np.load(os.path.join(run, "prototypes", "bb.npy"))
    assert bb.shape == (76, 6)
    matched = out["push"].winners >= 0
    assert (bb[matched, 0] == out["push"].winners[matched]).all()
    assert ((bb[matched, 1] >= 0) & (bb[matched, 2] <= 48) &
            (bb[matched, 1] < bb[matched, 2])).all()
    assert os.path.exists(os.path.join(run, "prototypes", "road",
                                       "prototype-img-original0.png"))

    pruned = run_pruning.main(["scaleproto_cityscapes", "run"] + common)
    assert pruned["source"].endswith(os.path.join("checkpoints", "push_last"))
    sd, meta = load_checkpoint(pruned["pruned"])
    assert meta["extra"] == {"variant": "multiscale",
                             "kept": [int(i) for i in pruned["kept"]]}
    assert sd["prototype_vectors"].shape[0] == len(pruned["kept"]) < 76
    assert os.path.exists(pruned["alias"] + ".pth")
    book = os.path.join(run, "pruned_prototypes_epoch0_k6_pt3")
    assert json.load(open(os.path.join(book, "prototypes_to_keep.json"))) \
        == [int(i) for i in pruned["kept"]]

    ft = train_wandb.main(["scaleproto_cityscapes", "run", "--pruned"] +
                          common + gin)
    res = ft["phases"][2]
    assert res.steps_done == 2 and np.isfinite(res.losses).all()
    after, _ = load_checkpoint(ft["final"])
    assert ft["final"] == pruned["alias"]
    assert not torch.equal(after["last_layer.weight"],
                           sd["last_layer.weight"])
    for key, v in sd.items():
        if key != "last_layer.weight":
            torch.testing.assert_close(after[key], v, rtol=0, atol=0,
                                       msg=key)
    assert os.path.exists(os.path.join(run, "pruned", "checkpoints",
                                       "push_best.pth"))

    out_dir = teval_test.main(["run", "pruned"] + common)
    for i in range(3):
        png = read_png(os.path.join(out_dir, f"t{i}.png"))
        assert png.shape == (40, 44)
        assert set(np.unique(png)) <= set(
            teval_test.train_id_to_source_lut()[1:20].tolist())
    res = eval_valid_multiscale.run_evaluation(
        "run", "pruned", data_root=root, results_root=results, device="cpu")
    assert np.isfinite(res["mean_iou"])
    assert os.path.exists(os.path.join(run, "evaluation", "pruned",
                                       "mean_iou.txt"))
    record = serve.main(["run", "pruned", "--input", test_dir, "--output",
                         str(tmp_path / "labels"), "--raw-output",
                         "--results-root", results, "--device", "cpu"])
    assert record["images"] == 3


@pytest.mark.parametrize("cli", ["run_pruning", "train_wandb", "eval_test",
                                 "threshold_save"])
def test_pruning_clis_default_to_cuda(cli, tmp_path, monkeypatch):
    """Without ``--device`` each CLI asks for the card and raises where
    there is none; so does ``train_wandb`` without ``--pruned`` (the
    single-scale baseline)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {"run_pruning": ["scaleproto_cityscapes", "run"],
            "train_wandb": ["scaleproto_cityscapes", "run", "--pruned"],
            "eval_test": ["run", "pruned"],
            "threshold_save": ["run", "final-group", "0.1"]}[cli]
    main = {"run_pruning": run_pruning.main, "train_wandb": train_wandb.main,
            "eval_test": teval_test.main,
            "threshold_save": tthreshold.main}[cli]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(argv + ["--results-root", str(tmp_path)])
    if cli == "train_wandb":
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["baseline_cityscapes", "run", "--results-root",
                  str(tmp_path)])
    with pytest.raises(NotImplementedError, match="scale-out"):
        tfind.find_k_nearest_patches_to_prototypes([], None, None,
                                                   mesh=object())
