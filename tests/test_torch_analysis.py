"""The interpretability analysis CLIs of the port against the JAX
package's, end to end on the CPU (``--device cpu``).

Two run directories from the same ``synthetic_init`` weights of the
tiny-depth flagship (full widths: 228 prototypes of depth 64 over 4
scales, 19 classes), written by each package (the JAX ``.ckpt`` and the
port's ``.pth``): a grouped one at ``final-group``, with the
``th-0.05-nopush-group_last`` checkpoint each package's ``threshold_save``
writes, and a plain one at ``push_final``; the factories' block tables
patched to one ResNet block a stage.  A Cityscapes-layout val split of 5
images of 41 x 81 (raw category labels, part ids in ``annotations_PIDS``
for 4 of them).  Each CLI runs on both runs where it applies:

- consistency (with ``--group-name`` on the grouped run) and stability:
  the scores equal, their CSVs equal after parsing;
- prototype and group overlap: the IoUs within 1e-6 wherever JAX's
  activation at every pixel whose mask differs lies more than 1e-5
  relative from its threshold, ``summary.json`` alike;
- group composition: ``composition.json`` equal;
- nearest images and prototypes: the distances within 1e-5 relative, the
  indices equal where JAX's distances lie more than 1e-5 relative apart;
- prototype and group samples and failure cases: the same file names,
  their panels' arrays (images equal, labels equal where JAX's top-two
  logit margin is at least 1e-5, maps within 1e-5) and titles;
- each CLI's arguments are the JAX CLI's plus ``--device``, and each
  refuses to run without a card unless ``--device cpu`` is given.
"""

import csv
import json
import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from scaleprotoseg_torch.analysis import (failure_cases, group_composition,
                                          group_overlap, nearest_img,
                                          nearest_proto, panels,
                                          prototype_overlap,
                                          sample_activations_group,
                                          sample_activations_prototype)
from scaleprotoseg_torch.analysis import threshold_save as tthreshold
from scaleprotoseg_torch.analysis.common import (activation_from_distance,
                                                 quantile_masks)
from scaleprotoseg_torch.analysis.common import \
    normalize_image as tnormalize
from scaleprotoseg_torch.analysis.metrics import consistency, stability
from scaleprotoseg_torch.checkpoints.convert import (ppnet_params_to_statedict,
                                                     save_checkpoint)
from scaleprotoseg_torch.models import factory as tfactory
from torch_parity import jax_flagship, port_model, port_spec, to_numpy_tree
from torch_parity import two_threads  # noqa: F401 (autouse)

H, W = 41, 81
N_VAL = 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"group": "group_scaleproto_cityscapes.gin",
           "plain": "scaleproto_cityscapes.gin"}
STAGE = {"group": "final-group", "plain": "push_final"}
RUN = {"group": "grun", "plain": "prun"}
TINY = (1, 1, 2, 1)


@pytest.fixture(scope="module")
def tiny_factories():
    """Both packages build ResNet stages of one block (two in layer3)."""
    from scaleprotoseg_tpu.models import factory as jfactory
    jdeeplab = jfactory._deeplab

    def tiny(n_features, n_blocks, *a, **kw):
        return jdeeplab(n_features, TINY, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfactory, "_deeplab", tiny)
        for name, (cfg, _, mode) in list(tfactory._BACKBONES.items()):
            mp.setitem(tfactory._BACKBONES, name, (cfg, TINY, mode))
        yield


def _write_data(root: str) -> str:
    from scaleprotoseg_torch.constants import CITYSCAPES_19_EVAL_CATEGORIES
    rng = np.random.default_rng(7)
    cats = [0] + [next(k for k, v in CITYSCAPES_19_EVAL_CATEGORIES.items()
                       if v == c) for c in range(1, 20)]
    ids = [f"val_{i}" for i in range(N_VAL)]
    for sub in ("img_with_margin_0", "annotations", "annotations_PIDS"):
        os.makedirs(os.path.join(root, sub, "val"))
    palette = rng.integers(30, 226, (256, 3))
    for i, img_id in enumerate(ids):
        grid = rng.permutation(cats)[:8].reshape(2, 4).astype(np.uint8)
        label = np.repeat(np.repeat(grid, 21, 0), 21, 1)[:H, :W]
        if i == 0:                       # one class over 20% of the image
            label[20:, :] = cats[1]
        np.save(os.path.join(root, "annotations", "val", img_id + ".npy"),
                np.ascontiguousarray(label))
        img = palette[label] + rng.integers(-30, 31, (H, W, 3))
        np.save(os.path.join(root, "img_with_margin_0", "val",
                             img_id + ".npy"), img.astype(np.uint8))
        if i == N_VAL - 1:
            continue                     # an image without part annotations
        parts = np.full((H, W), -1, np.int32)
        for k in range(12):              # parts 1..6 in blobs, 6 > max
            y, x = rng.integers(0, H - 4), rng.integers(0, W - 6)
            parts[y:y + rng.integers(2, 8), x:x + rng.integers(2, 12)] = \
                1 + k % 6
        np.save(os.path.join(root, "annotations_PIDS", "val",
                             img_id + ".npy"), parts)
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump({"train": [], "val": ids}, f)
    return root


@pytest.fixture(scope="module")
def setup(tmp_path_factory, tiny_factories):
    """(jax results root, port results root, data root, {kind: (JAX
    model, JAX variables, port model, spec)})."""
    from scaleprotoseg_tpu.analysis.threshold_save import threshold_save
    from scaleprotoseg_tpu.checkpoints.io import save_checkpoint as jsave
    root = tmp_path_factory.mktemp("analysis")
    data = _write_data(str(root / "city"))
    jroot, troot = str(root / "jax"), str(root / "port")
    models = {}
    for kind, seed in (("group", 3), ("plain", 4)):
        model, spec, variables = jax_flagship(kind == "group", side=H,
                                              seed=seed)
        tspec = port_spec(spec)
        sd = ppnet_params_to_statedict(
            to_numpy_tree(variables["params"]),
            to_numpy_tree(variables["batch_stats"]), tspec,
            log=lambda _: None)
        extra = {"variant": "group" if kind == "group" else "multiscale"}
        stems = [STAGE[kind]] + (["nopush-group_last"]
                                 if kind == "group" else [])
        for base in (jroot, troot):
            run = os.path.join(base, RUN[kind])
            os.makedirs(os.path.join(run, "checkpoints"))
            shutil.copyfile(os.path.join(REPO, "scaleprotoseg_tpu",
                                         "configs", CONFIGS[kind]),
                            os.path.join(run, "config.gin"))
            for stem in stems:
                path = os.path.join(run, "checkpoints", stem)
                if base == jroot:
                    jsave(path + ".ckpt", variables["params"],
                          variables["batch_stats"], spec=spec, extra=extra)
                else:
                    save_checkpoint(path, sd, tspec, extra=extra)
        models[kind] = (model, variables,
                        port_model(model, spec, variables), spec)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RESULTS_DIR", jroot)
        threshold_save("grun", "nopush-group", 0.05)
    tthreshold.main(["grun", "nopush-group", "0.05", "--results-root",
                     troot, "--device", "cpu"])
    return jroot, troot, data, models


@pytest.fixture
def port_env(setup, monkeypatch):
    jroot, troot, data, _ = setup
    monkeypatch.setenv("RESULTS_DIR", troot)
    monkeypatch.setenv("DATA_PATH_CITY", data)
    return setup


def _jargs(setup):
    jroot, _, data, _ = setup
    return dict(results_root=jroot, data_root=data)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _csv_equal(a, b):
    ha, ra = _read_csv(a)
    hb, rb = _read_csv(b)
    assert ha == hb and len(ra) == len(rb) > 0
    for x, y in zip(ra, rb):
        for u, v in zip(x, y):
            try:
                fu = float(u) if u else np.nan
                fv = float(v) if v else np.nan
            except ValueError:
                assert u == v
                continue
            assert fu == fv or (np.isnan(fu) and np.isnan(fv)), (u, v, x)


def _metric_dir(root, kind):
    return os.path.join(root, RUN[kind], "metrics", STAGE[kind])


@pytest.mark.parametrize("kind", ["group", "plain"])
def test_consistency_and_stability_match_jax(port_env, kind):
    from scaleprotoseg_tpu.analysis.metrics.consistency import \
        run_consistency
    from scaleprotoseg_tpu.analysis.metrics.stability import run_stability
    jroot, troot, _, _ = port_env
    group = ["--group-name", "grun"] if kind == "group" else []
    argv = [RUN[kind], STAGE[kind], "cityscapes", "--device", "cpu", *group]
    jkw = dict(group_name="grun" if group else None, **_jargs(port_env))
    got = consistency.main(argv)
    want = run_consistency(RUN[kind], STAGE[kind], "cityscapes", **jkw)
    assert got == want
    got_s = stability.main(argv)
    want_s = run_stability(RUN[kind], STAGE[kind], "cityscapes", **jkw)
    assert got_s == want_s
    for name in ("part_presence_th_0.8_qt_0.8.csv",
                 "part_presence_mean_th_0.8_qt_0.8.csv",
                 "tot_presence_stab_qt_0.8.csv",
                 "consistency_score_th_0.8_qt_0.8.txt",
                 "stability_score_qt_0.8.txt"):
        a = os.path.join(_metric_dir(troot, kind), name)
        b = os.path.join(_metric_dir(jroot, kind), name)
        if name.endswith(".txt"):
            with open(a) as fa, open(b) as fb:
                assert float(fa.read()) == float(fb.read())
        else:
            _csv_equal(a, b)
    _, rows = _read_csv(os.path.join(_metric_dir(troot, kind),
                                     "part_presence_th_0.8_qt_0.8.csv"))
    assert {r[-1] for r in rows} == {f"val_{i}" for i in range(N_VAL - 1)}


def _write_pascal_data(root: str) -> str:
    """A Pascal-layout val split of 4 images of 41 x 81: raw VOC ids 0-18
    and 255 (the 19-class models' range), the filtered ids (raw 4 and 9,
    ``PASCAL_FILTER_CLASS`` 5 and 10 after the conversion) in every image,
    part ids 1-25 (25 past ``MAX_PARTS_PASCAL``), the last image without a
    part file."""
    rng = np.random.default_rng(11)
    ids = [f"2008_{i:06d}" for i in range(4)]
    for sub in ("img_with_margin_0", "annotations", "annotations_PIDS"):
        os.makedirs(os.path.join(root, sub, "val"))
    palette = rng.integers(30, 226, (256, 3))
    for i, img_id in enumerate(ids):
        grid = np.concatenate([[4, 9, 255], rng.choice(
            [c for c in range(19) if c not in (4, 9)], 5, replace=False)])
        label = np.repeat(np.repeat(rng.permutation(grid).reshape(2, 4),
                                    21, 0), 21, 1)[:H, :W].astype(np.uint8)
        np.save(os.path.join(root, "annotations", "val", img_id + ".npy"),
                label)
        img = palette[label] + rng.integers(-30, 31, (H, W, 3))
        np.save(os.path.join(root, "img_with_margin_0", "val",
                             img_id + ".npy"), img.astype(np.uint8))
        if i == len(ids) - 1:
            continue                     # an image without part annotations
        parts = np.full((H, W), -1, np.int32)
        for k in range(16):
            y, x = rng.integers(0, H - 4), rng.integers(0, W - 6)
            parts[y:y + rng.integers(2, 8), x:x + rng.integers(2, 12)] = \
                1 + (7 * k) % 25
        np.save(os.path.join(root, "annotations_PIDS", "val",
                             img_id + ".npy"), parts)
    with open(os.path.join(root, "all_images.json"), "w") as f:
        json.dump({"train": [], "val": ids}, f)
    return root


@pytest.mark.parametrize("kind", ["group", "plain"])
def test_consistency_and_stability_on_pascal_match_jax(setup, kind,
                                                       tmp_path,
                                                       monkeypatch):
    """Pascal's branch: ``PASCAL_FILTER_CLASS`` left out, 25 part columns,
    class names through ``PASCAL_ID_MAPPING``, the image without a part
    file skipped; scores and CSVs equal to the JAX package's."""
    from scaleprotoseg_tpu.analysis.metrics.consistency import \
        run_consistency
    from scaleprotoseg_tpu.analysis.metrics.stability import run_stability
    from scaleprotoseg_torch.analysis.common import dataset_meta
    from scaleprotoseg_torch.constants import PASCAL_FILTER_CLASS
    jroot, troot, _, _ = setup
    data = _write_pascal_data(str(tmp_path / "pascal"))
    monkeypatch.setenv("RESULTS_DIR", troot)
    monkeypatch.setenv("DATA_PATH_PASCAL", data)
    group = ["--group-name", "grun"] if kind == "group" else []
    argv = [RUN[kind], STAGE[kind], "pascal", "--device", "cpu", *group]
    jkw = dict(group_name="grun" if group else None, results_root=jroot,
               data_root=data)
    assert consistency.main(argv) == run_consistency(
        RUN[kind], STAGE[kind], "pascal", **jkw)
    assert stability.main(argv) == run_stability(
        RUN[kind], STAGE[kind], "pascal", **jkw)
    for name in ("part_presence_th_0.8_qt_0.8.csv",
                 "part_presence_mean_th_0.8_qt_0.8.csv",
                 "tot_presence_stab_qt_0.8.csv"):
        _csv_equal(os.path.join(_metric_dir(troot, kind), name),
                   os.path.join(_metric_dir(jroot, kind), name))
    header, rows = _read_csv(os.path.join(_metric_dir(troot, kind),
                                          "part_presence_th_0.8_qt_0.8.csv"))
    cls2name, max_parts, _ = dataset_meta("pascal")
    assert max_parts == 24 and len(header) == max_parts + 1 + 3
    assert {r[-1] for r in rows} == {f"2008_{i:06d}" for i in range(3)}
    filtered = {cls2name[c - 1] for c in PASCAL_FILTER_CLASS}
    assert rows and not {r[-2] for r in rows} & filtered
    assert {r[-2] for r in rows} <= set(cls2name.values())


def _jax_distances(setup, kind, img_id):
    from scaleprotoseg_tpu.analysis.common import make_distance_fn
    from scaleprotoseg_tpu.analysis.common import normalize_image
    jroot, _, data, models = setup
    model, variables, _, _ = models[kind]
    img = np.load(os.path.join(data, "img_with_margin_0", "val",
                               img_id + ".npy"))
    return make_distance_fn(model)(variables, normalize_image(img)), img


def _overlap_gate(maps_j, maps_t):
    """Masks of JAX's (k, ...) maps and the port's: every pixel where they
    differ lies within 1e-5 relative of JAX's threshold."""
    thr = np.array([np.quantile(m, 0.8) for m in maps_j])
    mj = maps_j > thr.reshape(-1, *[1] * (maps_j.ndim - 1))
    mt = quantile_masks(torch.from_numpy(maps_t), 0.8).numpy()
    near = np.abs(maps_j - thr.reshape(mj.shape[0], *[1] * (mj.ndim - 1))) \
        <= 1e-5 * np.abs(thr.reshape(mj.shape[0], *[1] * (mj.ndim - 1)))
    return bool(np.all(near[mj != mt]))


@pytest.mark.parametrize("kind", ["group", "plain"])
def test_prototype_overlap_matches_jax(port_env, kind):
    from scaleprotoseg_tpu.analysis.common import \
        activation_from_distance as jact
    from scaleprotoseg_tpu.analysis.prototype_overlap import \
        run_proto_activation
    jroot, troot, _, models = port_env
    got = prototype_overlap.main([RUN[kind], STAGE[kind], "cityscapes",
                                  "--device", "cpu", "--n-images", "3"])
    want = run_proto_activation(RUN[kind], STAGE[kind], "cityscapes",
                                n_images=3, **_jargs(port_env))
    assert len(got) == len(want) == 3 * 19 * 66
    rec = want.to_dict("records")
    tm = models[kind][2]
    for g, w in zip(got, rec):
        assert g[:4] == [w["img_id"], w["class"], w["proto_a"],
                         w["proto_b"]]
        if abs(g[4] - w["iou"]) > 1e-6:
            d, img = _jax_distances(port_env, kind, g[0])
            dt = tm.push_forward(tnormalize(img)[None])[1][0]
            pair = [g[2], g[3]]
            assert _overlap_gate(
                np.moveaxis(np.asarray(jact(d[:, :, pair])), -1, 0),
                activation_from_distance(dt[:, :, pair]).permute(2, 0, 1)
                .detach().numpy()), g
    out = [os.path.join(r, RUN[kind], "analysis", "prototype_overlap",
                        STAGE[kind]) for r in (troot, jroot)]
    header, rows = _read_csv(os.path.join(out[0], "pair_iou_qt_0.8.csv"))
    assert header == list(want.columns)
    assert [[r[0], *map(int, r[1:4]), float(r[4])] for r in rows] == got
    ta, ja = [], []
    for d, s_ in ((out[0], ta), (out[1], ja)):
        with open(os.path.join(d, "summary.json")) as f:
            s_.append(json.load(f))
    ta, ja = ta[0], ja[0]
    assert list(ta["per_class"]) == list(ja["per_class"])
    assert len(ta["per_class"]) == 19
    np.testing.assert_allclose(list(ta["per_class"].values()),
                               list(ja["per_class"].values()), atol=1e-6)
    assert ta["mean_iou"] == pytest.approx(ja["mean_iou"], abs=1e-6)


def test_group_overlap_and_composition_match_jax(port_env):
    from scaleprotoseg_tpu.analysis.group_composition import group_comp
    from scaleprotoseg_tpu.analysis.group_overlap import run_group_overlap
    jroot, troot, data, models = port_env
    got = group_overlap.main(["grun", "final-group", "cityscapes",
                              "--device", "cpu", "--n-images", "3"])
    want = run_group_overlap("grun", "final-group", "cityscapes",
                             n_images=3, **_jargs(port_env))
    rec = want.to_dict("records")
    assert len(got) == len(rec) == 3 * 19 * 3
    model, variables, tm, spec = models["group"]
    from scaleprotoseg_tpu.analysis.common import normalize_image
    for g, w in zip(got, rec):
        assert g[:4] == [w["img_id"], w["class"], w["group_a"],
                         w["group_b"]]
        if abs(g[4] - w["iou"]) > 1e-6:
            img = np.load(os.path.join(data, "img_with_margin_0", "val",
                                       g[0] + ".npy"))
            gj = np.asarray(model.apply(variables, jnp.asarray(
                normalize_image(img))[None], train=False)
                .group_activations[0])
            gt = tm(tnormalize(img)[None]).group_activations[0]
            pair = [g[2], g[3]]
            assert _overlap_gate(
                np.moveaxis(gj[:, :, g[1], pair], -1, 0),
                gt[:, :, g[1], pair].permute(2, 0, 1).detach().numpy()), g
    with open(os.path.join(troot, "grun", "analysis", "group_overlap",
                           "final-group", "summary.json")) as f:
        ts = json.load(f)
    assert ts["mean_iou"] == pytest.approx(float(want.iou.mean()), abs=1e-6)

    comp = group_composition.main(["grun", "final-group", "--device",
                                   "cpu"])
    jcomp = group_comp("grun", "final-group", results_root=jroot)
    assert comp == jcomp
    paths = [os.path.join(r, "grun", "analysis", "group_composition",
                          "final-group", "composition.json")
             for r in (troot, jroot)]
    with open(paths[0]) as a, open(paths[1]) as b:
        assert json.load(a) == json.load(b)
    assert sum(len(v) for v in comp.values()) > 0


def _decided_order(values: np.ndarray, rtol=1e-5) -> np.ndarray:
    """Per position of the ascending ``values``, whether it lies more than
    ``rtol`` relative from both neighbours."""
    s = np.sort(values)
    gap = np.diff(s) > rtol * np.maximum(np.abs(s[1:]), 1e-30)
    ok = np.ones(len(s), bool)
    ok[1:] &= gap
    ok[:-1] &= gap
    return ok


class _FakeAxes:
    def __init__(self):
        self.layers, self.title = [], ""

    def imshow(self, a, cmap=None, alpha=None, **_):
        self.layers.append((np.asarray(a), cmap, alpha))

    def set_title(self, t):
        self.title = t

    def axis(self, *_):
        pass


@pytest.fixture
def figures(monkeypatch):
    """{file name: [(layers, title) per panel]} of the JAX package's
    figures (``plt.subplots`` replaced) and of the port's ``Figure``s
    (recorded, then written)."""
    import matplotlib.pyplot as plt
    caught = {"jax": {}, "port": {}}

    def subplots(nrows, ncols, figsize=None, squeeze=True):
        axes = np.empty(ncols, dtype=object)
        for i in range(ncols):
            axes[i] = _FakeAxes()

        class Fig:
            def tight_layout(self):
                pass

            def savefig(self, path, **_):
                caught["jax"][os.path.basename(path)] = [
                    (ax.layers, ax.title) for ax in axes]
        return Fig(), (axes if squeeze else axes.reshape(1, ncols))

    monkeypatch.setattr(plt, "subplots", subplots)
    monkeypatch.setattr(plt, "close", lambda *_: None)
    save = panels.Figure.savefig

    def record(self, path, **kw):
        caught["port"][os.path.basename(path)] = [
            ([(np.asarray(torch.as_tensor(a).cpu()), c, al)
              for a, c, al in layers], t)
            for layers, t in zip(self.layers, self.titles)]
        return save(self, path, **kw)

    monkeypatch.setattr(panels.Figure, "savefig", record)
    return caught


def _panels_equal(got, want, label_ok=None):
    """Panel by panel: the same colour maps and alphas, images equal,
    label maps equal where ``label_ok`` (decided), float maps within
    1e-5."""
    assert len(got) == len(want)
    for (gl, gt), (wl, wt) in zip(got, want):
        assert gt == wt
        assert [(c, a) for _, c, a in gl] == [(c, a) for _, c, a in wl]
        for (ga, c, _), (wa, _, _) in zip(gl, wl):
            assert ga.shape == wa.shape
            if wa.dtype == np.uint8:
                np.testing.assert_array_equal(ga, wa)
            elif c == "tab20":
                ok = label_ok if label_ok is not None else \
                    np.ones(wa.shape, bool)
                np.testing.assert_array_equal(ga[ok], wa[ok])
            else:
                np.testing.assert_allclose(ga, wa, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["group", "plain"])
def test_nearest_img_and_proto_match_jax(port_env, figures, kind):
    from scaleprotoseg_tpu.analysis.nearest_img import nearest_img as jni
    from scaleprotoseg_tpu.analysis.nearest_proto import \
        nearest_proto as jnp_
    jroot, troot, _, _ = port_env
    args = [RUN[kind], STAGE[kind], "cityscapes", "--device", "cpu"]
    got = nearest_img.main(args + ["--top-n", "2", "--limit", "3"])
    want = jni(RUN[kind], STAGE[kind], "cityscapes", top_n=2, limit=3,
               **_jargs(port_env))
    assert set(got) == set(want) and len(got) == 228
    undecided = set()
    for p, ranks in want.items():
        gd = np.array([r["distance"] for r in got[p]])
        wd = np.array([r["distance"] for r in ranks])
        np.testing.assert_allclose(gd, wd, rtol=1e-5)
        ok = np.abs(np.diff(wd)) > 1e-5 * np.abs(wd[1:])
        for r in range(len(ranks)):
            if (r == 0 or ok[r - 1]) and (r == len(ranks) - 1 or ok[r]):
                assert got[p][r]["img_id"] == ranks[r]["img_id"]
            else:
                undecided.add(p)
    assert len(undecided) < len(want) // 4
    for p in want:
        name = f"proto_{p}.png"
        assert os.path.exists(os.path.join(
            troot, RUN[kind], "analysis", "nearest_img", STAGE[kind], name))
        if p not in undecided:
            _panels_equal(figures["port"][name], figures["jax"][name])

    got = nearest_proto.main(args + ["--top-k", "3", "--n-images", "3"])
    want = jnp_(RUN[kind], STAGE[kind], "cityscapes", top_k=3, n_images=3,
                **_jargs(port_env))
    assert list(got) == list(want)
    for img_id, top in want.items():
        d, _ = _jax_distances(port_env, kind, img_id)
        mins = np.asarray(d).reshape(-1, d.shape[-1]).min(0)
        decided = _decided_order(mins)[:3].all()
        np.testing.assert_allclose([t["distance"] for t in got[img_id]],
                                   [t["distance"] for t in top], rtol=1e-5)
        if decided:
            assert [t["proto_id"] for t in got[img_id]] == \
                [t["proto_id"] for t in top]
            assert got[img_id] == [dict(t, distance=g["distance"])
                                   for t, g in zip(top, got[img_id])]
            _panels_equal(figures["port"][img_id + ".png"],
                          figures["jax"][img_id + ".png"])


def _label_ok(setup, kind, img_id):
    """Where JAX's top-two logit margin on the grid is at least 1e-5."""
    from scaleprotoseg_tpu.analysis.common import normalize_image
    _, _, data, models = setup
    model, variables, _, _ = models[kind]
    img = np.load(os.path.join(data, "img_with_margin_0", "val",
                               img_id + ".npy"))
    logits = np.asarray(model.apply(variables, jnp.asarray(
        normalize_image(img))[None], train=False).logits[0])
    top2 = np.sort(logits, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) >= 1e-5


@pytest.mark.parametrize("kind", ["group", "plain"])
def test_samples_and_failures_match_jax(port_env, figures, kind):
    from scaleprotoseg_tpu.analysis.failure_cases import \
        failure_cases as jfail
    from scaleprotoseg_tpu.analysis.sample_activations_group import \
        sample_activations_group as jgroup
    from scaleprotoseg_tpu.analysis.sample_activations_prototype import \
        sample_activations as jproto
    jroot, troot, _, _ = port_env
    args = [RUN[kind], STAGE[kind], "cityscapes", "--device", "cpu",
            "--n-images", "2"]
    runs = [("sample_activations_prototype", sample_activations_prototype,
             jproto)]
    if kind == "group":
        runs.append(("sample_activations_group", sample_activations_group,
                     jgroup))
    runs.append(("failure_cases", failure_cases, jfail))
    compared = {}
    for script, mod, jfn in runs:
        figures["port"].clear()
        figures["jax"].clear()
        mod.main(args)
        jfn(RUN[kind], STAGE[kind], "cityscapes", n_images=2,
            **_jargs(port_env))
        out = os.path.join(troot, RUN[kind], "analysis", script,
                           STAGE[kind])
        assert sorted(os.listdir(out)) == sorted(figures["jax"]) == \
            sorted(figures["port"])
        assert len(figures["jax"]) == 2, script
        for name, want in figures["jax"].items():
            ok = _label_ok(port_env, kind, name[:-4])
            if script == "failure_cases":
                # the error panel's class and strongest prototypes depend
                # on the labels: compare them where every label is decided
                if not ok.all():
                    continue
            _panels_equal(figures["port"][name], want, label_ok=ok)
            compared[script] = compared.get(script, 0) + 1
    assert compared.get("failure_cases", 0) >= 1, compared


_CLIS = {
    "consistency": (consistency, "scaleprotoseg_tpu.analysis.metrics."
                    "consistency", True),
    "stability": (stability, "scaleprotoseg_tpu.analysis.metrics."
                  "stability", True),
    "prototype_overlap": (prototype_overlap, "scaleprotoseg_tpu.analysis."
                          "prototype_overlap", True),
    "group_overlap": (group_overlap, "scaleprotoseg_tpu.analysis."
                      "group_overlap", True),
    "group_composition": (group_composition, "scaleprotoseg_tpu.analysis."
                          "group_composition", False),
    "nearest_img": (nearest_img, "scaleprotoseg_tpu.analysis.nearest_img",
                    True),
    "nearest_proto": (nearest_proto, "scaleprotoseg_tpu.analysis."
                      "nearest_proto", True),
    "sample_activations_prototype": (
        sample_activations_prototype,
        "scaleprotoseg_tpu.analysis.sample_activations_prototype", True),
    "sample_activations_group": (
        sample_activations_group,
        "scaleprotoseg_tpu.analysis.sample_activations_group", True),
    "failure_cases": (failure_cases, "scaleprotoseg_tpu.analysis."
                      "failure_cases", True),
}


class _Parsed(Exception):
    pass


def _arguments(main, monkeypatch):
    """{dest: (flags, default, type)} of the parser ``main`` builds."""
    import argparse
    seen = {}

    def parse(self, *_a, **_k):
        seen.update({a.dest: (tuple(a.option_strings), a.default, a.type)
                     for a in self._actions if a.dest != "help"})
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse)
    with pytest.raises(_Parsed):
        main()
    monkeypatch.undo()
    return seen


@pytest.mark.parametrize("cli", sorted(_CLIS))
def test_cli_arguments_and_default_device(cli, monkeypatch, tmp_path):
    """The JAX CLI's arguments plus ``--device``; without ``--device``
    the CLI asks for the card and raises where there is none."""
    import importlib
    mod, jname, data_type = _CLIS[cli]
    jmain = importlib.import_module(jname).main
    got = _arguments(mod.main, monkeypatch)
    want = _arguments(jmain, monkeypatch)
    assert got.pop("device") == (("--device",), None, None)
    assert got == want
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("RESULTS_DIR", str(tmp_path))
    argv = ["run", "final-group"] + (["cityscapes"] if data_type else [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
