"""Tensor ops shared by the models and the kernels' plain versions."""
