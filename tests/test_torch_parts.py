"""The part pass of the consistency and stability metrics, and the
pieces under it, against the JAX package's and against cv2, numpy and
pandas, on the CPU.

- ``cv2_nearest_index`` equal to ``cv2.resize(..., INTER_NEAREST)``'s at
  the sizes where ``floor(i * src / dst)`` and ``F.interpolate`` differ
  from it, and at the logit grid to full-size upsamples;
- ``quantile_rows`` bit-equal to ``np.quantile`` on 300 seeded masked,
  upsampled float32 maps and at every quantile the CLIs take;
- ``component_centroids`` equal to ``cv2.connectedComponentsWithStats``'
  (label 0 included, NaN where the mask covers the image);
- ``part_intersect`` (the torch form) and ``part_intersect_plain`` (numpy
  + scipy) row for row equal to the JAX package's ``part_intersect`` on
  the same distance arrays: a class under 20% of the image (threshold 0),
  one over it, parts absent from a class, a part id above ``max_parts``,
  ``filter_class_ids``, ``filter_proto_ids``, NaN or 0 for absent parts;
- the CSV writer, ``group_mean`` and ``inner_merge`` against pandas.
"""

import io
import os

import numpy as np
import pytest
import torch

from scaleprotoseg_torch.analysis.common import quantile_rows
from scaleprotoseg_torch.analysis.metrics.parts import (
    component_centroids, cv2_nearest_index, part_intersect,
    part_intersect_plain, resize_nearest_cv2)
from scaleprotoseg_torch.analysis.tables import (group_mean, inner_merge,
                                                 records, write_csv)
from scaleprotoseg_torch.spec import ProtoSpec
from torch_parity import two_threads  # noqa: F401 (autouse)

cv2 = pytest.importorskip("cv2")

SIZES = [(81, 321), (81, 513), (63, 375), (129, 1024), (257, 2048),
         (6, 41), (11, 81), (9, 65), (17, 129), (65, 513), (7, 3)]


@pytest.mark.parametrize("src,dst", SIZES)
def test_cv2_nearest_index_matches_cv2(src, dst):
    a = np.arange(src, dtype=np.float32)[None].repeat(2, 0)
    want = cv2.resize(a, (dst, 2), interpolation=cv2.INTER_NEAREST)[0]
    np.testing.assert_array_equal(cv2_nearest_index(dst, src), want)
    m = np.random.default_rng(src).random((src, src + 3)).astype(np.float32)
    np.testing.assert_array_equal(
        resize_nearest_cv2(m, dst, dst + 5),
        cv2.resize(m, (dst + 5, dst), interpolation=cv2.INTER_NEAREST))


def _masked_maps(rng, n, h=9, w=17, out=(65, 129)):
    """Seeded maps as the part pass thresholds them: activations on a
    logit grid, nearest-upsampled and masked to a random class block."""
    maps = []
    for _ in range(n):
        d = rng.gamma(2.0, 2.0, (h, w)).astype(np.float32)
        act = np.log((d + 1.0) / (d + 1e-4))
        up = resize_nearest_cv2(act, *out)
        mask = np.zeros(out, bool)
        y0, x0 = rng.integers(0, out[0] - 2), rng.integers(0, out[1] - 2)
        mask[y0:y0 + rng.integers(2, out[0]),
             x0:x0 + rng.integers(2, out[1])] = True
        maps.append(up * mask)
    return np.stack(maps)


@pytest.mark.parametrize("quantile", [0.8, 0.5, 0.25, 0.0, 1.0, 0.95])
def test_quantile_rows_bit_equal_to_numpy(quantile):
    rng = np.random.default_rng(int(quantile * 100))
    maps = _masked_maps(rng, 300 if quantile == 0.8 else 40)
    flat = maps.reshape(len(maps), -1)
    want = np.array([np.quantile(m, quantile) for m in flat])
    assert want.dtype == np.float32
    got = quantile_rows(torch.from_numpy(flat), quantile).numpy()
    np.testing.assert_array_equal(got, want)
    # unreplicated values, odd lengths
    x = rng.standard_normal((7, 1001)).astype(np.float32)
    np.testing.assert_array_equal(
        quantile_rows(torch.from_numpy(x), quantile).numpy(),
        np.array([np.quantile(r, quantile) for r in x]))
    # a class's values alone, the n - m zeros of its mask implied: rows
    # with negatives and zeros of their own, classes of 1% to 99%
    for m in (13, 500, 990):
        x = np.round(rng.standard_normal((5, m)), 1).astype(np.float32)
        x[1] = np.abs(x[1])
        want = np.array([np.quantile(np.concatenate(
            [r, np.zeros(1000 - m, np.float32)]), quantile) for r in x])
        np.testing.assert_array_equal(
            quantile_rows(torch.from_numpy(x), quantile, n=1000).numpy(),
            want)


def _cv2_centroids(mask):
    _, _, stats, cents = cv2.connectedComponentsWithStats(
        mask.astype(np.uint8), 8, cv2.CV_32S)
    keep = stats[:, cv2.CC_STAT_AREA] > 0
    return cents[keep]


@pytest.mark.parametrize("seed", range(6))
def test_component_centroids_match_cv2(seed):
    rng = np.random.default_rng(seed)
    h, w = 37, 53
    mask = rng.random((h, w)) < [0.05, 0.2, 0.5, 0.9, 1.0, 0.02][seed]
    if seed == 1:                      # 2-pixel-wide blobs: .5 centroids
        mask[:] = False
        mask[3:9, 4:6] = mask[20:22, 30:41] = mask[30, 0:2] = True
    if not mask.any():
        mask[5, 5] = True
    ys, xs = np.nonzero(mask)
    got = component_centroids(ys, xs, h, w)
    want = _cv2_centroids(mask)
    # cv2 and scipy may number the components in another order
    np.testing.assert_array_equal(got[np.lexsort(got.T)],
                                  want[np.lexsort(want.T)])
    np.testing.assert_array_equal(np.round(got[np.lexsort(got.T)]),
                                  np.round(want[np.lexsort(want.T)]))


def _city_ids(*names):
    from scaleprotoseg_torch.constants import CITYSCAPES_19_NAMES
    return [CITYSCAPES_19_NAMES.index(n) + 1 for n in names]


def _part_case(seed, h=65, w=129):
    """(cls_ann, part_ann) of converted labels: road over 40% of the
    image (parts 1, 2, 7: 7 is above max_parts), a car block (parts 1, 5
    in two blobs each), a person block (parts 2, 3), a sky block without
    parts, void."""
    rng = np.random.default_rng(seed)
    road, car, person, sky = _city_ids("road", "car", "person", "sky")
    cls = np.zeros((h, w), np.int64)
    parts = np.full((h, w), -1, np.int32)
    cls[26:, :] = road
    cls[5:20, 10:40] = car
    cls[5:20, 60:70] = person
    cls[0:4, 90:120] = sky
    parts[30:40, 5:50] = 1
    parts[45:60, 60:100] = 2
    parts[50:55, 110:120] = 7
    parts[6:9, 12:20] = 1
    parts[15:19, 30:38] = 1
    parts[10:12, 14:16] = 5
    parts[12:14, 34:36] = 5
    parts[6:12, 61:69] = 2
    parts[14:19, 62:65] = 3
    parts[0:2, 0:5] = 4                # a part in void: no class holds it
    shift = int(rng.integers(0, 3))
    return np.roll(cls, shift, 1), np.roll(parts, shift, 1)


CASES = {
    "consistency": dict(),
    "stability": dict(nan_missing_parts=False),
    "filter_class": dict(filter_class_ids=_city_ids("car")),
    "filter_proto": dict(filter_proto_ids="every other"),
    "quantile_0.5": dict(quantile=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("grid", [(9, 17), (6, 11)])
def test_part_intersect_matches_jax(case, grid):
    from scaleprotoseg_tpu.analysis.common import dataset_meta
    from scaleprotoseg_tpu.analysis.metrics.parts import \
        part_intersect as jpart
    from scaleprotoseg_tpu.spec import ProtoSpec as JSpec
    jspec = JSpec.equal_allocation(228, 64, num_classes=19, num_scales=4)
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19, num_scales=4)
    cls2name, max_parts, _ = dataset_meta("cityscapes")
    kw = {"quantile": 0.8, "max_parts": max_parts, **CASES[case]}
    if case == "filter_proto":
        kw["filter_proto_ids"] = [
            int(p) for c in range(19)
            for p in np.nonzero(spec.class_identity[:, c])[0][::2]]
    h, w = (65, 129) if grid == (9, 17) else (41, 81)
    cls_ann, part_ann = _part_case(sum(grid), h, w)
    rng = np.random.default_rng(len(case))
    d = rng.gamma(2.0, 2.0, (*grid, 228)).astype(np.float32)
    want = jpart(d, cls_ann, part_ann, jspec, cls2name, "img", **kw)
    plain = part_intersect_plain(d, cls_ann, part_ann, spec, cls2name,
                                 "img", **kw)
    dev = part_intersect(torch.from_numpy(d), cls_ann, part_ann, spec,
                         cls2name, "img", **kw)
    assert len(want) > 0
    for got in (plain, dev):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.array(a[:-2], np.float64),
                                          np.array(b[:-2], np.float64))
            assert a[-2:] == b[-2:]
    rows = np.array([r[:max_parts + 1] for r in want], np.float64)
    # the cases exercise hits, misses and absent parts
    assert (rows == 1).any()
    if case in ("consistency", "stability"):
        assert (rows == 0).any()
    assert np.isnan(rows).any() == kw.get("nan_missing_parts", True)


def test_csv_tables_match_pandas(tmp_path):
    pd = pytest.importorskip("pandas")
    cols = ["part_0", "part_1", "part_2", "proto_id", "class", "img_id"]
    rows = [[np.nan, 1, 0, 5, "car", "a"], [np.nan, 0, 0, 3, "car", "b"],
            [np.nan, 1, np.nan, 5, "car", "b"], [np.nan, 1, 1, 40, "road",
                                                 "a"],
            [np.nan, 0, 1, 3, "car", "a"], [np.nan, 1, 1, 40, "road, x",
                                            "c"]]
    ours = str(tmp_path / "ours.csv")
    write_csv(ours, cols, rows)
    df = pd.DataFrame(rows, columns=cols)
    buf = io.StringIO()
    df.to_csv(buf, index=False)
    with open(ours) as f:
        assert f.read() == buf.getvalue()
    part_cols = cols[:3]
    got = group_mean(records(cols, rows), ["class", "proto_id"], part_cols)
    want = df.groupby(["class", "proto_id"])[part_cols].agg(
        lambda x: np.nanmean(x)).reset_index()
    assert [(g["class"], g["proto_id"]) for g in got] == \
        list(zip(want["class"], want["proto_id"]))
    np.testing.assert_array_equal(
        np.array([[g[c] for c in part_cols] for g in got]),
        want[part_cols].to_numpy(np.float64))
    right = [[0, 1, 5, "car", "b"], [1, 1, 5, "car", "a"],
             [0, 0, 3, "car", "a"], [1, 0, 9, "car", "a"]]
    rcols = ["part_stab_0", "part_stab_1", "proto_id", "class", "img_id"]
    keys = ["proto_id", "class", "img_id"]
    merged = inner_merge(records(cols, rows), records(rcols, right), keys)
    wm = df.merge(pd.DataFrame(right, columns=rcols), on=keys)
    assert [list(m) for m in merged] == [list(wm.columns)] * len(merged)
    np.testing.assert_array_equal(
        np.array([[m[c] for c in wm.columns if c not in ("class", "img_id")]
                  for m in merged], np.float64),
        wm.drop(columns=["class", "img_id"]).to_numpy(np.float64))
    assert [m["img_id"] for m in merged] == list(wm["img_id"])
    out = str(tmp_path / "merged.csv")
    write_csv(out, list(wm.columns), [[m[c] for c in wm.columns]
                                      for m in merged])
    buf = io.StringIO()
    wm.to_csv(buf, index=False)
    with open(out) as f:
        assert f.read() == buf.getvalue()
    assert os.path.getsize(out) > 0
