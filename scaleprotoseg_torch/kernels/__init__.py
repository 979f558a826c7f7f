"""Hand-written CUDA kernels of the serving path and their launch counts.

Each wrapper launches its kernel for a CUDA tensor (building it from
``csrc/`` on first use) and runs its plain PyTorch version for a CPU
tensor.  ``fn.launches`` counts kernel launches only.
"""

from scaleprotoseg_torch.kernels._build import build
from scaleprotoseg_torch.kernels.aspp import fused_aspp
from scaleprotoseg_torch.kernels.proto import fused_proto_logits
from scaleprotoseg_torch.kernels.upsample import fused_upsample_argmax

WRAPPERS = {
    "aspp": fused_aspp,
    "proto": fused_proto_logits,
    "upsample": fused_upsample_argmax,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["build", "fused_aspp", "fused_proto_logits",
           "fused_upsample_argmax", "launch_counts", "reset_launch_counts",
           "WRAPPERS"]
