"""Prototype push of the port against the JAX package's, on the CPU.

The tiny-depth grouped flagship (full widths: 228 prototypes of depth 64)
with the JAX package's synthetic weights, carried over by
``ppnet_params_to_statedict``; prototypes 0 and 1 made equal, so that
dedup prunes.  Six seeded 33 x 33 images in three batches, labels in
blocks holding void and every class.  Both pushes must give:

- the same winner image and pixel for every prototype whose best masked
  distance beats its second best by more than 1e-4 (1 + d) in the JAX
  package's own distances (torch and XLA float32 differ by ~1e-6; a
  nearer tie may go either way);
- winning distances within rtol 1e-5, and pushed vectors within atol
  1e-5 where the winners agree;
- the same kept prototypes, pruned spec and pruned group heads.

Also: ``spec.prune`` / ``keep_indices`` and the sidecar round trip,
``prune_model_params`` in both branches, the refusals of a shuffling or
order-changing loader, K1's packed head walked at the pushed and pruned
bank against the Pallas kernel in interpret mode, and the prototype-phase
CLI with push on.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from __graft_entry__ import _flagship, synthetic_init
from scaleprotoseg_tpu.ops.pallas_proto import fused_proto_logits
from scaleprotoseg_tpu.ops.resize import resize_label_nearest
from scaleprotoseg_tpu.push import push as jpush
from scaleprotoseg_tpu.spec import ProtoSpec
from scaleprotoseg_torch import cli_common
from scaleprotoseg_torch import train_wandb_multiscale as trainer
from scaleprotoseg_torch.checkpoints.convert import (load_checkpoint,
                                                     ppnet_params_to_statedict)
from scaleprotoseg_torch.kernels.proto import pack_head
from scaleprotoseg_torch.model_loading import load_model
from scaleprotoseg_torch.models.ppnet import PPNet
from scaleprotoseg_torch.push import push as tpush
from scaleprotoseg_torch.spec import ProtoSpec as TProtoSpec
from e2e_utils import build_synthetic_dataset
from torch_parity import (emulate_proto_kernel, port_model, port_spec,
                          to_numpy_tree)
from torch_parity import own_sigterm_guard  # noqa: F401 (autouse)

SIDE = 33


class Loader:
    """A fixed-order, re-iterable list of (images, labels) batches."""

    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)


def _batches(seed=0, n=3):
    rng = np.random.default_rng(seed)
    y = np.repeat(np.repeat(np.arange(20).reshape(4, 5), 9, 0), 7, 1)
    out = []
    for i in range(n):
        x = rng.standard_normal((2, SIDE, SIDE, 3)).astype(np.float32)
        labels = np.stack([np.roll(y[:SIDE, :SIDE], (3 * i + s, 5 * s),
                                   axis=(0, 1)) for s in (0, 1)])
        out.append((x, labels.astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def pushed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("push")
    model, spec = _flagship(tiny=True, grouped=True, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=0)
    pv = np.array(variables["params"]["prototype_vectors"])
    pv[1] = pv[0]
    variables["params"]["prototype_vectors"] = jnp.asarray(pv)
    loader = Loader(_batches())
    want = jpush.push_prototypes(model, variables, spec, loader,
                                 prototypes_dir=str(tmp / "jax"),
                                 log=lambda _: None)
    tm = port_model(model, spec, variables)
    got = tpush.push_prototypes(tm, port_spec(spec), loader,
                                prototypes_dir=str(tmp / "port"),
                                log=lambda _: None)

    # the JAX package's masked distances, for the best-to-second margin
    @jax.jit
    def masked(images, targets):
        _, d = model.apply(variables, images, method="push_forward")
        t = resize_label_nearest(targets, d.shape[1], d.shape[2]) - 1
        cls = jnp.asarray(spec.class_ids[:spec.num_active_prototypes])
        d = jnp.where(t[..., None] == cls, d, d + jpush.MAX_DIST)
        return d.reshape(-1, d.shape[-1])

    cand = np.concatenate([np.asarray(masked(jnp.asarray(x), jnp.asarray(y)))
                           for x, y in loader])
    two = np.sort(cand, axis=0)[:2]
    margin = two[1] - two[0]
    decided = margin > 1e-4 * (1.0 + two[0])
    return dict(model=model, spec=spec, want=want, got=got, tm=tm,
                decided=decided, tmp=tmp)


def test_push_matches_jax(pushed):
    want, got, decided = pushed["want"], pushed["got"], pushed["decided"]
    spec = pushed["spec"]
    assert decided.mean() > 0.8
    np.testing.assert_array_equal(got.winners[decided],
                                  want.winners[decided])
    want_flat = np.load(pushed["tmp"] / "jax" / "push_info.npz")[
        "best_flat"]
    np.testing.assert_array_equal(got.flat_idx[decided], want_flat[decided])
    np.testing.assert_allclose(got.min_dists, want.min_dists, rtol=1e-5)
    # dedup: prototypes 0 and 1 were equal, so 1 is gone, and the rest of
    # the kept set and the pruned spec agree
    assert 1 not in got.kept
    np.testing.assert_array_equal(got.kept, want.kept)
    assert got.spec == port_spec(want.spec)
    assert got.spec.num_prototypes < spec.num_prototypes
    # pushed vectors (kept rows) where the winners agree, and the pruned
    # heads
    sd = ppnet_params_to_statedict(to_numpy_tree(want.params), None,
                                   got.spec, log=lambda _: None)
    keep_decided = decided[got.kept]
    np.testing.assert_allclose(
        got.state_dict["prototype_vectors"].flatten(1).numpy()[keep_decided],
        sd["prototype_vectors"].reshape(len(got.kept), -1)[keep_decided],
        rtol=0, atol=1e-5)
    for k, v in sd.items():
        if k.startswith(("group_projection.", "last_layer_group")):
            np.testing.assert_array_equal(got.state_dict[k].numpy(), v,
                                          err_msg=k)
    # the records
    for name in ("unique_prototypes.json",):
        assert json.loads((pushed["tmp"] / "port" / name).read_text()) == \
            json.loads((pushed["tmp"] / "jax" / name).read_text())
    info_t = np.load(pushed["tmp"] / "port" / "push_info.npz")
    info_j = np.load(pushed["tmp"] / "jax" / "push_info.npz")
    assert sorted(info_t.files) == sorted(info_j.files)
    for k in ("kept", "scale_ids"):
        np.testing.assert_array_equal(info_t[k], info_j[k])


def test_pushed_model_loads_at_the_pruned_spec(pushed):
    """The pruned state dict loads strictly into a model of the pruned
    spec, and each kept prototype sits at distance ~0 from its winning
    pixel (the float32 forward)."""
    got, tm = pushed["got"], pushed["tm"]
    new = PPNet(tm.features.base, got.spec, grouped=True)
    new.load_state_dict(got.state_dict, strict=True)
    images = np.concatenate([x for x, _ in _batches()])
    with torch.no_grad():
        _, d = new.eval().push_forward(torch.from_numpy(images))
    d = d.reshape(len(images), -1, d.shape[-1])
    p = new.prototypes().detach()
    for j, i in enumerate(got.kept):
        if j >= got.spec.num_active_prototypes:
            break
        at = d[got.winners[i], got.flat_idx[i], j]
        assert float(at) <= 1e-5 * (1.0 + float((p[j] ** 2).sum())), j


def test_k1_walks_the_pushed_pruned_bank(pushed, rng):
    """K1's packed head (``pack_head``) walked as ``csrc/proto.cu`` walks
    it, at the bank push left (pushed vectors, dedup-pruned spec), against
    the JAX package's Pallas kernel in interpret mode: rtol = atol = 1e-4,
    the card's tolerance."""
    want, got = pushed["want"], pushed["got"]
    jspec = want.spec
    tspec = got.spec
    feats = rng.random((2, 3, 5, jspec.feature_depth)).astype(np.float32)
    feats = feats.astype(jnp.bfloat16).astype(np.float32)
    p = want.params
    ref = np.asarray(fused_proto_logits(
        jnp.asarray(feats), p["prototype_vectors"], None, jspec,
        group_projection=p["group_projection"],
        last_layer_group=p["last_layer_group"], interpret=True, tile_n=128))
    new = PPNet(pushed["tm"].features.base, tspec, grouped=True)
    new.load_state_dict(got.state_dict, strict=True)
    gw, glw = new.group_weights()
    head = pack_head(new.prototypes().detach(), None, tspec,
                     group_projection=gw.detach(),
                     last_layer_group=glw.detach())
    out = emulate_proto_kernel(torch.from_numpy(feats), head, tspec)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grouped", [False, True], ids=["plain", "group"])
@pytest.mark.parametrize("case", ["scattered", "class_emptied"])
def test_prune_model_params_matches_jax(grouped, case):
    model, spec = _flagship(tiny=True, grouped=grouped, dtype=jnp.float32)
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, SIDE, SIDE, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=2)
    drop = [0, 7, 60, 61, 130, 227]
    if case == "class_emptied":
        drop += [p for p, c in enumerate(spec.class_ids) if c == 4]
    new_spec = spec.prune(drop)
    keep = spec.keep_indices(drop)
    params = jpush.prune_model_params(dict(variables["params"]), keep,
                                      old_spec=spec, new_spec=new_spec)
    tnew = port_spec(new_spec)
    want = ppnet_params_to_statedict(to_numpy_tree(params), None, tnew,
                                     log=lambda _: None)
    tm = port_model(model, spec, variables)
    got = tpush.prune_model_params(tm.state_dict(), keep, port_spec(spec),
                                   tnew)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert not [k for k in got if k.startswith("group_projection.")
                and k not in want]
    # and the result loads into a model of the pruned spec
    PPNet(tm.features.base, tnew, grouped=grouped).load_state_dict(
        got, strict=True)


@pytest.mark.parametrize("drop", [[], [5], [0, 1, 2, 57, 58, 227],
                                  list(range(57, 114))])
def test_spec_prune_matches_jax(drop):
    spec = ProtoSpec.equal_allocation(228, 64, num_classes=19, num_groups=3)
    tspec = port_spec(spec)
    want, got = spec.prune(drop), tspec.prune(drop)
    assert got == port_spec(want)
    np.testing.assert_array_equal(tspec.keep_indices(drop),
                                  spec.keep_indices(drop))
    assert TProtoSpec.from_meta(got.to_meta()) == got
    for name in ("scale_ids", "group_class_identity",
                 "class_proto_scale_mask", "class_scale_counts"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    assert got.with_groups(0).num_groups == 0


def _narrow_model():
    from scaleprotoseg_torch.models.deeplab import DeepLabV2
    spec = TProtoSpec.equal_allocation(76, 16, num_classes=19)
    backbone = DeepLabV2(n_out=16, n_blocks=(1, 1, 1, 1),
                         atrous_rates=(6, 12, 18, 24), aspp_mode="concat")
    return PPNet(backbone, spec, generator=torch.Generator().manual_seed(0)), \
        spec


def test_push_refuses_a_shuffling_or_reordered_loader():
    model, spec = _narrow_model()
    batches = _batches(n=2)
    shuffling = Loader(batches)
    shuffling.shuffle = True
    with pytest.raises(ValueError, match="fixed-order"):
        tpush.push_prototypes(model, spec, shuffling, log=lambda _: None)

    class Reordering(Loader):
        passes = 0

        def __iter__(self):
            self.passes += 1
            return iter(self.batches if self.passes == 1
                        else self.batches[::-1])

    with pytest.raises(RuntimeError, match="second pass"):
        tpush.push_prototypes(model, spec, Reordering(batches),
                              log=lambda _: None)
    # the order check comes first: artifacts are never written from a
    # loader that could hand them another image
    with pytest.raises(ValueError, match="fixed-order"):
        tpush.push_prototypes(model, spec, shuffling, save_artifacts=True,
                              log=lambda _: None)


def test_push_runs_float32_and_restores_the_recipe():
    model, spec = _narrow_model()
    model.set_compute_dtype(torch.bfloat16)
    model.features.base.aspp.fast = True
    model.train()
    seen = []
    forward = model.push_forward

    def spy(x):
        seen.append((model.dtype, model.features.base.aspp.fast,
                     model.training))
        return forward(x)

    model.push_forward = spy
    before = model.prototype_vectors._version
    tpush.push_prototypes(model, spec, Loader(_batches(n=1)),
                          log=lambda _: None)
    assert seen == [(torch.float32, False, False)]
    assert (model.dtype, model.features.base.aspp.fast, model.training) == \
        (torch.bfloat16, True, True)
    assert model.prototype_vectors._version > before


TINY = ["train.warmup_steps = 2", "train.joint_steps = 2",
        "train.finetune_steps = 2",
        "construct_PPNet.base_architecture = 'deeplabv2_resnet50_multiscale'",
        "deeplabv2_resnet50_features_multiscale.deeplab_n_features = 16",
        "construct_PPNet.prototype_shape = (76, 16, 1, 1)",
        "PatchClassificationDataset.window_size = (33, 33)",
        "PatchClassificationModuleMultiScale.iter_size = 1",
        "PatchClassificationDataModule.dataloader_n_jobs = 2"]


def test_cli_pushes_on_cpu(tmp_path):
    """The prototype-phase CLI with push on (narrow ResNet-50, 2 + 2
    micro-steps, push over four 48 x 48 images, 2 last-layer steps):
    ``push_last`` and the push records are written, dedup prunes the bank
    (the synthetic set holds three label values, so prototypes of absent
    classes land on shared pixels), phase 2 trains the pruned model, and
    ``push_final`` loads at the pruned spec with every kept prototype at
    distance ~0 from its winning pixel."""
    root = build_synthetic_dataset(str(tmp_path / "data"), n_train=4,
                                   n_val=2, size=48)
    argv = ["scaleproto_cityscapes", "push_run", "--device", "cpu",
            "--data-root", root, "--results-root", str(tmp_path / "res")]
    for line in TINY:
        argv += ["--gin", line]
    out = trainer.main(argv)
    push = out["push"]
    assert sorted(out["phases"]) == [0, 1, 2]
    assert np.isfinite(out["phases"][2].losses).all()
    run = tmp_path / "res" / "push_run"
    assert (run / "prototypes" / "unique_prototypes.json").exists()
    assert json.loads((run / "prototypes" / "unique_prototypes.json")
                      .read_text()) == push.kept.tolist()
    assert push.spec.num_prototypes < 76
    _, meta = load_checkpoint(str(run / "checkpoints" / "push_last"))
    assert TProtoSpec.from_meta(meta["spec"]) == push.spec
    model, spec = load_model(str(run), str(run / "checkpoints" /
                                           "push_final.pth"), device="cpu")
    assert spec == push.spec
    # phase 2 trains the last layer only: the pushed bank is push_final's
    sd, _ = load_checkpoint(str(run / "checkpoints" / "push_last"))
    torch.testing.assert_close(model.prototype_vectors,
                               sd["prototype_vectors"], rtol=0, atol=0)
    _, bindings = cli_common.load_config(str(run / "config.gin"))
    images = np.concatenate([x for x, _ in cli_common.make_push_loader(
        bindings, data_root=root)])
    with torch.no_grad():
        _, d = model.push_forward(torch.from_numpy(images))
    d = d.reshape(len(images), -1, d.shape[-1])
    p = model.prototypes().detach()
    for j, i in enumerate(push.kept):
        at = d[push.winners[i], push.flat_idx[i], j]
        assert float(at) <= 1e-5 * (1.0 + float((p[j] ** 2).sum())), j
