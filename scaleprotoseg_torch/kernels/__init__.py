"""Hand-written CUDA kernels of the port and their launch counts.

Each wrapper launches its kernel for a CUDA tensor (building it from
``csrc/`` on first use) and runs its plain PyTorch version for a CPU
tensor.  ``fn.launches`` counts kernel launches only.
"""

from scaleprotoseg_torch.kernels._build import build
from scaleprotoseg_torch.kernels.aspp import (aspp_grad_pack,
                                              aspp_grad_weight, fused_aspp)
from scaleprotoseg_torch.kernels.int8 import (int8_absmax, int8_conv3x3,
                                              int8_mm, quantize_int8)
from scaleprotoseg_torch.kernels.proto import fused_proto_logits
from scaleprotoseg_torch.kernels.upsample import fused_upsample_argmax

WRAPPERS = {
    "aspp": fused_aspp,
    "aspp_grad_pack": aspp_grad_pack,
    "aspp_grad_weight": aspp_grad_weight,
    "int8_mm": int8_mm,
    "int8_conv3x3": int8_conv3x3,
    "quantize_int8": quantize_int8,
    "int8_absmax": int8_absmax,
    "proto": fused_proto_logits,
    "upsample": fused_upsample_argmax,
}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


__all__ = ["aspp_grad_pack", "aspp_grad_weight", "build", "fused_aspp",
           "fused_proto_logits", "fused_upsample_argmax", "int8_absmax",
           "int8_conv3x3", "int8_mm", "launch_counts", "quantize_int8",
           "reset_launch_counts", "WRAPPERS"]
