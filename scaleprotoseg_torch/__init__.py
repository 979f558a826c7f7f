"""PyTorch/CUDA port of scaleprotoseg_tpu for NVIDIA Hopper.

A package beside the JAX reference that imports neither JAX nor the JAX
package.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; hand-written kernels live in ``kernels/`` (wrappers)
and ``csrc/`` (CUDA sources).
"""
