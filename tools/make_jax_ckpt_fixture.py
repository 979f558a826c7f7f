"""Write ``tests/torch_fixtures/jax_ckpt/``: a small run directory as the
JAX package writes it, and the ``export-torch`` twin of its checkpoint.

    python tools/make_jax_ckpt_fixture.py

The model is EM's grouped UNet-ASPP (``configs/group_scaleproto_em.gin``)
at a U-Net base of 4, so that the files stay small; the head is the
config's (24 prototypes of depth 64, K1's depth, over 4 scales, 2
classes, 3 groups), and the trainable BN's running statistics are in
``batch_stats``.  The JAX package builds it from the config,
``__graft_entry__.synthetic_init`` (seed 21) fills it, and writes:

  config.gin                  the config the run directory holds
  final-group.ckpt            ``checkpoints.io.save_checkpoint`` (msgpack)
  final-group.ckpt.json       its sidecar (the spec, the variant)
  final-group_twin.pth        ``convert_checkpoint.export_torch`` of it
  MANIFEST.json               each file's size and SHA-256

``chip_smoke.py`` serves the ``.ckpt`` on the card, where neither JAX,
flax nor msgpack is installed, and holds its logits against the twin's.
Needs the JAX package; runs on the CPU in a few seconds.
"""

import hashlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "tests", "torch_fixtures", "jax_ckpt")
OVERRIDES = """
# the fixture's size (small files): a U-Net of base 4
unet_aspp_features.unet_base = 4
"""


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from __graft_entry__ import synthetic_init
    from scaleprotoseg_tpu import configlib
    from scaleprotoseg_tpu.checkpoints.io import save_checkpoint
    from scaleprotoseg_tpu.convert_checkpoint import export_torch
    from scaleprotoseg_tpu.models import factory

    with open(os.path.join(ROOT, "scaleprotoseg_tpu", "configs",
                           "group_scaleproto_em.gin")) as f:
        config = f.read() + OVERRIDES
    configlib.clear_config()
    configlib.parse_config(config)
    model, spec = factory.construct_PPNet_Group()
    configlib.clear_config()
    shapes = jax.eval_shape(
        lambda k: model.init(k, jnp.zeros((1, 64, 64, 3))),
        jax.random.PRNGKey(0))
    variables = synthetic_init(shapes, seed=21)
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "config.gin"), "w") as f:
        f.write(config)
    ckpt = os.path.join(OUT, "final-group.ckpt")
    save_checkpoint(ckpt, variables["params"], variables["batch_stats"],
                    spec=spec, extra={"variant": "group"})
    export_torch(ckpt, os.path.join(OUT, "final-group_twin.pth"))
    manifest = {}
    for name in sorted(os.listdir(OUT)):
        if name == "MANIFEST.json":
            continue
        with open(os.path.join(OUT, name), "rb") as f:
            data = f.read()
        manifest[name] = {"bytes": len(data),
                          "sha256": hashlib.sha256(data).hexdigest()}
    with open(os.path.join(OUT, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    print(json.dumps(manifest, indent=1))


if __name__ == "__main__":
    main()
