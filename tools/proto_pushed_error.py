"""K1 and the fp32 plain head against the float64 head at pushed
prototypes, at several banks and seeds, on the card.

    python tools/proto_pushed_error.py

The construction of ``tests/test_torch_cuda.py``'s
``test_proto_kernel_at_pushed_prototypes``: 2 x 13 x 17 bf16 features,
every prototype a seeded pixel's features (d = 0 there, where the log
activation's slope is -1e4), a group head of 3 groups with rows on the
simplex and a last layer of scale 0.1.  Prints, per bank (prototypes /
classes) and seed, the largest float64 logit and the largest absolute
error of K1 and of the fp32 plain head over it, and the bound the test
holds both to there: ``kernels.proto.rounding_bound`` at 3 units of fp32
rounding a distance (the inputs' conditioning times fp32 rounding).  It
tells a kernel fault from the rounding of fp32 arithmetic at a bank.  A
development script: nothing of the port calls it.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scaleprotoseg_torch import kernels  # noqa: E402
from scaleprotoseg_torch.kernels.proto import (proto_float64,  # noqa: E402
                                               proto_plain, rounding_bound)
from scaleprotoseg_torch.spec import ProtoSpec  # noqa: E402

BANKS = ((2054, 171), (2054, 182), (2184, 182), (1800, 150), (228, 19))
SEEDS = (7, 0, 1, 2, 3)          # 7: the card test's


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("proto_pushed_error: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    kernels.build()
    for p, c in BANKS:
        for seed in SEEDS:
            gen = np.random.default_rng(seed)
            spec = ProtoSpec.equal_allocation(p, 64, num_classes=c,
                                              num_groups=3)
            feats = torch.from_numpy(gen.random(
                (2, 13, 17, 256), np.float32)).to(dev, torch.bfloat16)
            flat = feats.reshape(-1, 256).float()
            at = gen.integers(0, flat.shape[0], spec.num_prototypes)
            protos = torch.stack([
                flat[i, s * 64:(s + 1) * 64]
                for s, (lo, hi) in enumerate(spec.scale_bounds)
                for i in at[lo:hi]])
            mask = (spec.class_proto_index >= 0).astype(np.float32)
            gw = gen.random((c, 3, spec.max_protos_per_class)) * \
                mask[:, None, :]
            kw = dict(
                group_projection=torch.from_numpy(
                    (gw / gw.sum(-1, keepdims=True)).astype(np.float32)
                ).to(dev),
                last_layer_group=torch.from_numpy(gen.standard_normal(
                    (c * 3, c)).astype(np.float32) * 0.1).to(dev))
            got = kernels.fused_proto_logits(feats, protos, None, spec, **kw)
            plain = proto_plain(feats, protos, None, spec, **kw)
            want = proto_float64(feats, protos, None, spec, **kw)
            s = want.abs().max()
            plain_err = ((plain - want).abs().max() / s).item()
            print(f"P {p} C {c} seed {seed}: max|logit| {s.item():.4g}; "
                  f"kernel {((got - want).abs().max() / s).item():.4g}, "
                  f"fp32 plain {plain_err:.4g}, bound "
                  f"{rounding_bound(feats, protos, None, spec, **kw):.4g} on "
                  f"{torch.cuda.get_device_name(0)}", flush=True)


if __name__ == "__main__":
    main()
