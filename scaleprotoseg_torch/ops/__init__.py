"""Tensor ops shared by the models and the kernels' plain versions."""

import torch


def as_dtype(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` in ``dtype``, with no cast where it already is: a traced
    graph (``torch.export``) then holds no cast and no metadata assertion
    for it, host work on every call of the served program."""
    return t if t.dtype == dtype else t.to(dtype)
